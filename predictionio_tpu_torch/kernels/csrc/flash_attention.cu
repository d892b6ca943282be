// Flash attention forward (online softmax, causal or not), hand-written for
// Hopper (sm_90a).
//
// Replaces predictionio_tpu/ops/attention.py::_flash_kernel (:72-124, the body
// of the pl.pallas_call at :145 that flash_attention_pallas reaches). For every
// (batch * head, query row) it computes o = softmax(q k^T / sqrt(D), masked) v
// with the TPU kernel's rules:
//   - q is scaled by 1/sqrt(D) before the dot (the TPU kernel's :83), with
//     the factor rounded to float as the plain version rounds it, and the
//     exponentials are expf, as the plain version's are (exp2f on scores
//     carrying log2(e) would save a few instructions a score but change the
//     rounding that the sequence recommender's training check is held at;
//     see the softmax below);
//   - under causal a key is kept when q_pos >= k_pos, both counted from 0,
//     also when Lq != Lk; keys at or beyond Lk are masked here (the host pads
//     nothing);
//   - a masked score is the finite -1e30, and the result is o / max(l, 1e-30);
//   - key tiles are walked in ascending order from tile 0 and, under causal,
//     tiles wholly above the query tile's diagonal are skipped (:117-123: the
//     last tile walked is min(((i + 1) * bq + bk - 1) / bk, n_kv)).
// The ascending order is what keeps the finite mask safe: the running max m
// starts at -1e30, and a row whose first tile held no valid key would add
// exp(0) = 1 to l for every masked key. Tile 0 always holds key 0, which every
// row keeps, so m is a real score after the first tile and every later masked
// key adds exp(-1e30 - m) = 0 exactly.
//
// Contract (checked by tests/test_torch_flash.py through a numpy emulation of
// this kernel's order, by tests/test_torch_attention.py against the JAX kernel
// in interpret mode through the plain version, and by chip_smoke.py against
// the plain PyTorch version on the card): q [BH, Lq, D], k and v [BH, Lk, D], o
// [BH, Lq, D], all f32, contiguous and 16-byte aligned; D a multiple of 8 from
// 8 to kMaxD = 128; Lq, Lk >= 1. The wrapper
// (ops/cuda_kernels.py::flash_attention_fwd) takes any head width: from 1 to
// 128 it zero-pads q, k and v to the next multiple of 8, passes the true width
// for the scale, and slices o back; above 128, unpadded, it takes the resident
// path below up to kRMaxD = 272 (pio_flash_attention_resident), the streamed
// path up to kSMaxD = 320 (pio_flash_attention_streamed), the wide streamed
// path up to kWSMaxD = 512 (pio_flash_attention_wide_streamed), the cluster
// path up to kCMaxD = 1024 (pio_flash_attention_cluster) and the passes path
// above it (pio_flash_attention_wide), picked by D alone. It raises on
// anything else.
//
// Resident path (kMaxD < D <= kRMaxD). A block takes kRRows = 64 query rows of
// one (batch * head) and all of D, with kRThreads = 256 threads, walking the
// keys in tiles of kRKeys = 64. What is hard: O's registers grow with D, and
// the Q, K and V tiles with it (a [64][D] tile is 64 KB at D = 256), so the
// tuned path's two K/V buffers do not fit beside a resident Q tile. Design:
//   - the Q tile is copied once, scaled by 1/sqrt(D) of the true width, and
//     stays in shared memory across all key tiles; each tile's scores are
//     computed once and serve every output column;
//   - register micro-tiles: S in 4 rows x 4 keys a thread (rows s_row0 + i,
//     keys kx + 16 t; a row in one half-warp, so its max and sum take four
//     xor shuffles in a fixed order), with 16-byte loads along D (8 loads a
//     64 FMAs); O in 4 rows x G float4 column groups (rows pr + 16 i, groups
//     cx + 16 g, a warp 8 rows by 4 groups), G = res_groups(D) an
//     instantiation (3, 4, 5: D up to 192, 256, 272), so O stays in registers
//     (4 P and 4 G V loads a 64 G FMAs);
//   - one K and one V buffer, copied ahead in turn with cp.async: V of tile j
//     while QK^T of tile j runs, K of tile j + 1 while PV of tile j runs, two
//     barriers a tile; the rescale factor of each row and, at the end, l pass
//     from the S threads to the O threads through shared memory;
//   - rows in shared memory are D rounded up to 8 floats (zeros past D; a row
//     of w + 4 floats is an odd number of 16-byte groups, so the keys of one
//     load fall in distinct banks), copied 16 bytes at a time when D is a
//     multiple of 4 and the tensors 16-byte aligned, else 4 bytes at a time.
// Shared memory is 768 * res_width(D) + 19,968 bytes: 211.5 KB at D = 256, so
// one block an SM, and kRMaxD = 272 is the widest head that fits. The same
// rules as the tuned path: the finite -1e30 mask on every tile, key tiles
// ascending from tile 0 and causal tiles above the diagonal skipped, a masked
// key's V row zero, o / max(l, 1e-30), heaviest query tiles first, fp32 FMAs
// on the CUDA cores, no atomics. Bound at (8, 4, 2048, 256): 137 GFLOP not
// causal, 2.05 ms at 67 TFLOP/s; it is set by operations at every timed shape
// but the sequence recommender's training batch, where bytes set it.
//
// Streamed path (kRMaxD < D <= kSMaxD). What is hard: at D = 320 the
// resident path's whole-width K and V tiles no longer fit beside its Q tile
// (768 * 320 + 19,968 bytes against a block's 232,448), while its O registers
// (G = 5 float4 column groups a thread) still do. Design: the resident
// path's block, thread maps and arithmetic (64 query rows, 256 threads, key
// tiles of 64, the Q tile scaled once and kept in shared memory, S in 4 rows
// x 4 keys a thread, O in 4 rows x G float4 groups), with K and V streamed
// through shared memory in column chunks of kSChunk = 64:
//   - a key tile is a sequence of chunks, K's nc = ceil(w / 64) column chunks
//     then V's nc (w = D rounded up to 8); each score is one FMA chain over D
//     ascending, carried in registers from one K chunk to the next, so each
//     tile's scores are computed once for all of O's columns; V's chunk g
//     feeds O's column group g (4 rows x one float4 a thread), one
//     compile-time-unrolled step over g, so no register array is indexed at
//     run time;
//   - the chunks of the whole block, tile after tile, go through a ring of
//     kSStages = 2 buffers [64][kSCStride = 68] that K's and V's chunks take in
//     turn (a row of 17 16-byte groups, so the keys of one load fall in
//     distinct banks): chunk n + 1 is copied with cp.async while chunk n is
//     used, one barrier a chunk, which also publishes P and the rescale
//     factors before V's first chunk;
//   - the masks, the row max and sum, P and l as the resident path does them,
//     so a plan that forces this path at D <= kRMaxD gives the resident
//     kernel's answer bit for bit.
// Shared memory at D = 320 is 135,680 bytes (the Q tile 82,944, the ring
// 34,816, P 17,408, two row vectors), one block an SM, as its registers (216
// a thread on the card) also allow. One instantiation, G = kSGroups = 5,
// sets kSMaxD = 320; wider heads take the wide streamed path. The same rules
// as the other paths: the finite -1e30 mask on every tile, key tiles
// ascending from tile 0 and causal tiles above the diagonal skipped, a masked
// key's V row zero, o / max(l, 1e-30), heaviest query tiles first, fp32 FMAs
// on the CUDA cores, no atomics; 16-byte copies when D is a multiple of 4 and
// the tensors 16-byte aligned, else 4-byte ones (the wide streamed path keeps
// all of these). Bound at (8, 4, 2048, 320): 85.9 GFLOP
// causal, 1.28 ms at 67 TFLOP/s, set by operations; bytes set it at the
// sequence recommender's training batch.
//
// Wide streamed path (kSMaxD < D <= kWSMaxD). What is hard: a sixth float4
// group of O a thread would spill the streamed path's 256 threads, so its
// block cannot go past D = 320, and the passes path, which took those heads
// before, computes each key tile's scores again for every pass of 128 of O's
// columns (three times at D = 384), with one scalar shared load per FMA.
// Design: the streamed path's block at kWSThreads = 512 threads, so each
// thread holds half the rows:
//   - 64 query rows a block, 64-key tiles, the Q tile scaled once and kept in
//     shared memory (64 x 516 floats at D = 512), K's column chunks of
//     kWSKChunk = 64 then V's of kWSVChunk = 128 through a ring of kWSStages =
//     2 buffers, each chunk copied with cp.async while the one before is
//     used, one barrier a chunk; so each key tile's scores are computed once
//     for all of O's columns;
//   - S in 2 rows x 4 keys a thread (rows 2 (tid / 16) + i, keys kx + 16 t,
//     kx = lane % 16): a row sits in one half-warp and a thread holds the
//     streamed path's keys, so the row's max and sum take the streamed path's
//     order (a thread's keys in t order, then xor shuffles 1, 2, 4, 8) and a
//     plan that forces this path at D <= kSMaxD gives the streamed kernel's
//     answer bit for bit;
//   - O in 2 rows x G float4 column groups a thread (rows pr + 32 i, groups
//     cx + 16 g, a warp 8 rows by 4 groups), G = kWSGroups = 8 one
//     instantiation (64 registers of O; a V chunk wholly past D is skipped);
//     V's chunk of 128 columns feeds two groups, each probability loaded once
//     for both (with 64-column chunks: 5 % slower and 24 bytes spilled on the
//     card).
// Registers: 128 a thread, the cap of __launch_bounds__(512, 1), with no local
// memory; G = 9 and 10 spilled (16 and 56 bytes, with 64-column V chunks),
// which sets kWSMaxD = 512. Shared memory at D = 512 is 217,600 bytes, one
// block an SM. S is bound by shared loads (2 Q and 4 K float4 a thread for 32
// FMAs, 10 wavefronts a warp for 8 issue cycles), which makes the block slower
// than the streamed path's at the same width (on an H100 at 700 W, forced at
// D = 320: 4.41 against 3.19-3.24 ms at L = 2,048 causal). Bound at (8, 4, 2048, 384): 103 GFLOP causal, 1.54 ms at 67
// TFLOP/s, set by operations; bytes set it at the training batch.
//
// Cluster path (kWSMaxD < D <= kCMaxD). What is hard: past D = 512 the wide
// streamed block runs out of both registers (a ninth float4 group of O a
// thread spills under the 128 registers of 512 threads) and shared memory
// (its Q tile of 64 rows x D), and the passes path, which took those heads
// before, computes each key tile's scores again for every 128 of O's
// columns (five times at D = 576, eight at 1,024). Design: a query tile is
// split across a thread-block cluster of kCBlocks = 2 blocks, launched with
// cudaLaunchKernelEx and the cluster-dimension attribute; block rank r owns
// a contiguous slice of the columns (rank 0 the first cl_slice0(D) = D
// rounded up to 8, halved and rounded up to 8; rank 1 the rest), of Q, K, V
// and O, and is the wide streamed block on its slice (both blocks lay out
// their shared memory as rank 0's, so that a buffer lies at one offset in
// both):
//   - 512 threads, 64 query rows, 64-key tiles, the Q slice scaled once and
//     kept in shared memory, K's column chunks of 64 then V's of 128 through
//     the same two-buffer cp.async ring, S in 2 rows x 4 keys a thread, O in
//     2 rows x G = kCGroups = 8 float4 groups a thread (a slice of at most
//     512 columns, which sets kCMaxD = 1024);
//   - each block computes the partial score of its slice, one FMA chain over
//     its columns in ascending order; each thread stores its 8 partials
//     through distributed shared memory (mapa + st.shared::cluster) into the
//     partner block's probability buffer, at the places the partner's thread
//     of the same index reads them, and after a cluster barrier (arrive with
//     release, wait with acquire) adds the partner's to its own: s = s_0 +
//     s_1, one rounded add, which is commutative, so both blocks hold the
//     same S, m, l and P bit for bit;
//   - then the masks, the row max and sum and P exactly as the wide streamed
//     path, and PV on the block's own columns. P overwrites the partials in
//     place (each thread its own 8), so the exchange needs no shared memory
//     of its own: 217,600 bytes at a slice of 512, one block an SM;
//   - the buffer is reused next tile only after a second barrier phase: a
//     thread arrives once its block's PV has read P, and waits just before
//     its next exchange store, so the QK^T of the next tile hides that
//     phase. An arrive before the first tile, waited on before the first
//     store, makes sure the partner has started, and a wait after the last
//     tile keeps either block from leaving while the other may still store
//     into its memory.
// The finite -1e30 mask on every tile, key tiles ascending from tile 0 and
// causal tiles above the diagonal skipped (both blocks of a cluster walk the
// same tiles), a masked key's V row zero, o / max(l, 1e-30), q scaled by
// 1/sqrt(D) of the true width, heaviest query tiles first, 16-byte copies
// when D is a multiple of 4 and the tensors are aligned, fp32 FMAs on the
// CUDA cores, no atomics: two calls give the same bits. Bound at (8, 4,
// 2048, 1024): 275 GFLOP causal, 4.10 ms at 67 TFLOP/s, set by operations;
// bytes set it at the training batch.
//
// Passes path (D > kCMaxD), the first wide-head design. Of the two designs
// at hand (O's columns in passes with the scores recomputed each pass, or one
// warp a query row with O spread over its lanes) it takes the passes: a
// thread's O columns stay a fixed 16 registers whatever D is, so one
// instantiation takes every width, where a warp a row needs D / 32 registers
// of O a lane, one instantiation a width, and runs out of registers as D
// grows. A block takes
// kWRows = 32 query rows of one (batch * head) and one pass of at most kWCols
// = 128 of O's columns (a grid dimension: the passes of a query tile run as
// separate blocks), with kWThreads = 256 threads: thread (ry, kx) = (tid / 8,
// tid % 8) owns row ry, the keys kx + 8 t of a kWKeys = 32 key tile and the
// columns kx + 8 g of its pass. Per key tile, S over the whole D is summed in
// ascending order from Q and K staged kWChunk = 64 columns at a time (one fmaf
// a column), so every pass of a tile computes the same scores, m and l bit
// for bit; then the masks, the row max and sum over the row's 8 threads (three
// shuffles each, a fixed order), p to shared memory, and O's pass columns
// from the tile's V. Key tiles ascending from tile 0, causal tiles above the
// diagonal skipped, the finite -1e30 mask, masked and padded values read as
// 0, o / max(l, 1e-30), q scaled by 1/sqrt(D) before the dot, heaviest query
// tiles first; no atomics, and every register array is indexed by constants.
// Its cost over the tuned path: QK^T once per pass (twice at D = 256), one
// shared load per FMA in QK^T, and 32-key tiles; the resident path took its
// place wherever its tiles fit, the streamed path up to kSMaxD, the wide
// streamed path up to kWSMaxD and the cluster path up to kCMaxD.
//
// Design. A block takes BQ = 64 or 128 query rows of one (batch * head) and
// walks the keys in tiles of kTile = 64, with 2 * BQ threads. Thread (ry, kx)
// = (tid / 8, tid % 8) owns a register micro-tile of kRows = 4 query rows
// (ry + BQ/4 * i) in both products: in S = Q K^T the 8 keys kx + 8 t of the
// tile, in O the D / 8 columns kx * W + 8 W g (W = 4, 2 or 1 floats, the
// widest that divides D / 8). The 8 threads of a row sit in one warp, so a
// row's max and sum take three shuffles, and the probabilities a thread
// writes to shared memory are read back only by its own warp. The sum l is
// taken in a fixed order (see the softmax below). Q and K are
// kept row-major in shared memory with a stride of D + 4 floats (16-byte
// aligned; the eight keys and four rows one load instruction reads fall in
// distinct banks), and both products run on 16-byte shared loads: QK^T reads
// 4 query and 8 key float4 per 128 FMAs, PV reads 4 probability float4 and
// 4 * D/8 / W value vectors per 4 * 4 * D/8 FMAs, instead of one scalar
// load per FMA. The dot walks D in ascending order and PV the keys
// in ascending order, one FMA each. The Q tile and key tile 0 are 16-byte
// cp.async copies issued together and waited for once, and while tile j is
// scored tile j + 1 is copied into the other of two K/V buffers, with one
// barrier a tile. The causal test is applied only on a tile
// that crosses the diagonal (its last key above its first row) and the
// length test only on a tile that reaches past Lk; every other tile is used
// as it is. Under causal the blocks are issued heaviest first: block b takes
// query tile q_tiles - 1 - b / BH of head b % BH, so the tiles that walk the
// most keys do not form the last wave's tail. m, l and O stay in fp32
// registers; every loop over D is sized at compile time (one instantiation
// per (D, BQ)), and no register array is indexed at run time. No atomics:
// two calls give the same bits. All arithmetic is fp32 on the CUDA cores.
//
// Bound at the slice's shapes (the sequence recommender's training batch: B =
// 64, H = 4, L = 64, D = 16, causal, f32; H100 SXM data sheet: 3.35 TB/s, about
// 67 TFLOP/s fp32): q, k and v read once and o written once are 4.19 MB, 1.25
// us; the causal half of QK^T and PV is 34 MFLOP, 0.5 us. So the bound is set
// by bytes there, and by operations at (8, 4, 2048, 64): 17.2 GFLOP causal,
// 257 us. The register micro-tile lifts the products from one shared load per
// FMA (a quarter of the fp32 rate at most) to about one per ten; the copies
// ahead keep the loads of a block off its critical path.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kTile = 64;          // keys per K/V tile (bk), and the smaller BQ
constexpr int kRows = 4;           // query rows a thread owns in S and O
constexpr int kKeyThreads = 8;     // threads that share a row (one warp)
constexpr int kKeys = kTile / kKeyThreads;  // keys a thread owns in S: 8
constexpr int kPad = 4;            // floats after each Q and K row
constexpr int kPStride = kTile + 8;  // floats of a probability row
constexpr int kMaxD = 128;
constexpr int kMaxQTiles = 65535;  // query tiles of one (batch * head)
constexpr int kMaxBlocks = 2147483647;
constexpr float kNegBig = -1e30f;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;        // dynamic shared memory a block may opt into
constexpr int kSmSmem = 233472;         // shared memory of an SM, bytes
constexpr int kBlockSmemReserve = 1024;  // what the card keeps of it a block
// the passes path (D > kCMaxD)
constexpr int kWRows = 32;     // query rows a block
constexpr int kWKeys = 32;     // keys a tile
constexpr int kWThreads = 256;  // kWRows x kKeyThreads
constexpr int kWChunk = 64;    // columns of Q and K staged a step
constexpr int kWCols = 128;    // O's columns a pass (a block)
constexpr int kWMinBlocks = 4;  // launch bound: at most 64 registers a thread
// the resident wide-head path (kMaxD < D <= kRMaxD)
constexpr int kRRows = 64;      // query rows a block (bq)
constexpr int kRKeys = 64;      // keys a tile (bk)
constexpr int kRThreads = 256;
constexpr int kRPStride = kRKeys + 4;  // floats of a probability row
constexpr int kRMaxD = 272;     // the widest head whose resident tiles fit a block
// the streamed path (kRMaxD < D <= kSMaxD): the resident path's block with K
// and V streamed in column chunks
constexpr int kSRows = 64;      // query rows a block (bq)
constexpr int kSKeys = 64;      // keys a tile (bk)
constexpr int kSThreads = 256;
constexpr int kSChunk = 64;     // columns of a K or V chunk
constexpr int kSCStride = 68;   // floats of a chunk row
constexpr int kSStages = 2;     // chunk buffers: chunks are copied kSStages - 1 ahead
constexpr int kSGroups = 5;     // O's float4 column groups a thread
constexpr int kSMaxD = 320;     // the widest head of kSGroups
// the wide streamed path (kSMaxD < D <= kWSMaxD): the streamed path's block at
// 512 threads, two query rows a thread in S and in O
constexpr int kWSRows = 64;      // query rows a block (bq)
constexpr int kWSKeys = 64;      // keys a tile (bk)
constexpr int kWSThreads = 512;
constexpr int kWSKChunk = 64;    // columns of a K chunk
constexpr int kWSVChunk = 128;   // columns of a V chunk, a multiple of 64
constexpr int kWSKStride = kWSKChunk + 4;  // floats of a K chunk row
constexpr int kWSVStride = kWSVChunk + 4;  // floats of a V chunk row
constexpr int kWSStages = 2;     // chunk buffers: chunks are copied kWSStages - 1 ahead
constexpr int kWSGroups = 8;     // O's float4 column groups a thread
constexpr int kWSMaxD = 512;     // the widest head of kWSGroups
// the cluster path (kWSMaxD < D <= kCMaxD): a cluster of kCBlocks wide
// streamed blocks a query tile, each block a slice of D's columns
constexpr int kCBlocks = 2;      // blocks a cluster, one slice of D each
constexpr int kCGroups = 8;      // O's float4 column groups a thread
constexpr int kCMaxD = 1024;     // kCBlocks slices of kCGroups * 64 columns

// Floats of shared memory of a block of BQ rows at head width d: the Q tile
// [bq][d + kPad], two K tiles [kTile][d + kPad] and two V tiles [kTile][d]
// (the next tile is copied while this one is scored), the probabilities
// [bq][kPStride].
__host__ __device__ constexpr int smem_floats(int bq, int d) {
  return (bq + 2 * kTile) * (d + kPad) + 2 * kTile * d + bq * kPStride;
}

// The widest vector (4, 2 or 1 floats) that divides the D / 8 output columns
// of a thread.
__host__ __device__ constexpr int col_width(int d) {
  return (d / 8) % 4 == 0 ? 4 : ((d / 8) % 2 == 0 ? 2 : 1);
}

template <int W>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (W == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else if constexpr (W == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
    out[0] = *p;
  }
}

template <int W>
__device__ __forceinline__ void store_vec(float* p, const float* in) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
  } else {
    *p = in[0];
  }
}

// One 16-byte copy from device memory into shared memory that does not pass
// through registers (cp.async, L2 only); with `valid` false it writes zeros.
__device__ __forceinline__ void copy16(float* dst, const float* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts the copy of `rows` rows (those at or past `valid` as zeros: a masked
// key's value must be 0, never stale, since p * NaN = NaN) of width D from
// device memory into shared memory with row stride `stride`.
template <int D, int kThreads>
__device__ __forceinline__ void copy_rows(const float* __restrict__ src,
                                          float* dst, int rows, int stride,
                                          int valid, int tid) {
  for (int e = tid; e < rows * (D / 4); e += kThreads) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    const bool in = r < valid;
    copy16(dst + r * stride + c, in ? src + static_cast<size_t>(r) * D + c : src, in);
  }
}

// The launch bound's blocks an SM: for BQ = 64 as many as the shared memory
// holds, up to 3 (a cap of 170 registers, under which no width spills); for
// BQ = 128 one (a cap of 128 registers spilled from D = 48 on).
template <int D, int BQ>
__host__ __device__ constexpr int min_blocks() {
  constexpr int by_smem = kSmSmem / (smem_floats(BQ, D) * 4 + kBlockSmemReserve);
  return BQ > kTile ? 1 : (by_smem < 1 ? 1 : (by_smem > 3 ? 3 : by_smem));
}

template <int D, int BQ>
__global__ void __launch_bounds__(2 * BQ, (min_blocks<D, BQ>()))
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int BH, int Lq, int Lk, int q_tiles, int causal,
                           float qscale) {
  constexpr int kThreads = 2 * BQ;
  constexpr int kRowStep = BQ / kRows;  // a thread's rows are ry + kRowStep * i
  constexpr int ds = D + kPad;
  constexpr int kW = col_width(D);
  constexpr int kCols = D / kKeyThreads;  // output columns a thread owns
  constexpr int kGroups = kCols / kW;
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                    // [BQ][ds], pre-scaled
  float* s_k2 = s_q + BQ * ds;          // two [kTile][ds]
  float* s_v2 = s_k2 + 2 * kTile * ds;  // two [kTile][D]
  float* s_p = s_v2 + 2 * kTile * D;    // [BQ][kPStride]

  const int tid = threadIdx.x;
  const int kx = tid % kKeyThreads;
  const int ry = tid / kKeyThreads;
  // heaviest query tiles first (under causal they walk the most key tiles)
  const int bh = static_cast<int>(blockIdx.x % static_cast<unsigned>(BH));
  const int q_tile = q_tiles - 1 - static_cast<int>(blockIdx.x / static_cast<unsigned>(BH));
  const int q0 = q_tile * BQ;
  const float* q_bh = q + static_cast<size_t>(bh) * Lq * D;
  const float* k_bh = k + static_cast<size_t>(bh) * Lk * D;
  const float* v_bh = v + static_cast<size_t>(bh) * Lk * D;

  // the Q tile and key tile 0 in flight together
  copy_rows<D, kThreads>(q_bh + static_cast<size_t>(q0) * D, s_q, BQ, ds, Lq - q0, tid);
  copy_rows<D, kThreads>(k_bh, s_k2, kTile, ds, Lk, tid);
  copy_rows<D, kThreads>(v_bh, s_v2, kTile, D, Lk, tid);
  copies_commit();

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }
  const int n_kv = (Lk + kTile - 1) / kTile;
  // causal: key tiles wholly above this query tile's diagonal are skipped
  const int hi = causal ? min((q0 + BQ + kTile - 1) / kTile, n_kv) : n_kv;

  for (int j = 0; j < hi; ++j) {
    const int k0 = j * kTile;
    copies_wait();  // this thread's copies of tile j (and at j = 0 of Q) landed
    if (j == 0) {   // scale the Q vectors this thread copied
      for (int e = tid; e < BQ * (D / 4); e += kThreads) {
        float4* x = reinterpret_cast<float4*>(s_q + (e / (D / 4)) * ds + (e % (D / 4)) * 4);
        x->x *= qscale; x->y *= qscale; x->z *= qscale; x->w *= qscale;
      }
    }
    // tile j is visible to every thread, and every warp is done with tile
    // j - 1, whose buffers the next copy reuses
    __syncthreads();
    if (j + 1 < hi) {
      const size_t next = static_cast<size_t>(k0 + kTile) * D;
      copy_rows<D, kThreads>(k_bh + next, s_k2 + ((j + 1) & 1) * kTile * ds, kTile, ds,
                             Lk - k0 - kTile, tid);
      copy_rows<D, kThreads>(v_bh + next, s_v2 + ((j + 1) & 1) * kTile * D, kTile, D,
                             Lk - k0 - kTile, tid);
      copies_commit();
    }
    const float* s_k = s_k2 + (j & 1) * kTile * ds;
    const float* s_v = s_v2 + (j & 1) * kTile * D;

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int t = 0; t < kKeys; ++t) s[i][t] = 0.f;
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      float4 qv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(s_q + (ry + kRowStep * i) * ds + c);
#pragma unroll
      for (int t = 0; t < kKeys; ++t) {
        const float4 kv = *reinterpret_cast<const float4*>(s_k + (kx + kKeyThreads * t) * ds + c);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          s[i][t] = fmaf(qv[i].x, kv.x, s[i][t]);
          s[i][t] = fmaf(qv[i].y, kv.y, s[i][t]);
          s[i][t] = fmaf(qv[i].z, kv.z, s[i][t]);
          s[i][t] = fmaf(qv[i].w, kv.w, s[i][t]);
        }
      }
    }
    // the masks, only where a kept score can differ from a computed one
    const bool cross = causal && k0 + kTile - 1 > q0;
    if (cross || k0 + kTile > Lk) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int q_pos = q0 + ry + kRowStep * i;
#pragma unroll
        for (int t = 0; t < kKeys; ++t) {
          const int k_pos = k0 + kx + kKeyThreads * t;
          const bool keep = k_pos < Lk && (!causal || q_pos >= k_pos);
          s[i][t] = keep ? s[i][t] : kNegBig;
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int t = 1; t < kKeys; ++t) mx = fmaxf(mx, s[i][t]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float* p_row = s_p + (ry + kRowStep * i) * kPStride + kx;
      // The tile's sum in the order of four threads a row holding keys
      // g + 4 n each: the keys g, g + 4, g + 8, ... (g = kx % 4) one after
      // another, then across g by two shuffles. Keys g + 8 t are this
      // thread's, g + 4 + 8 t its partner's (kx ^ 4). The sequence
      // recommender's three-step training check (kernel against plain
      // attention, logits to atol 1e-4) is held at the outputs of that
      // order: three AdamW steps amplify a one-ulp change in l to about
      // 1e-4 in the logits.
      const bool low = kx < kKeyThreads / 2;
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kKeys; ++t) {
        const float p = expf(s[i][t] - m_new);
        p_row[kKeyThreads * t] = p;
        const float other = __shfl_xor_sync(0xffffffffu, p, kKeyThreads / 2);
        sum += low ? p : other;
        sum += low ? other : p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[i] = fmaf(l[i], corr, sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
    __syncwarp();  // a row's probabilities are written and read by one warp

#pragma unroll 4
    for (int kk = 0; kk < kTile; kk += 4) {
      float pv[kRows][4];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        load_vec<4>(s_p + (ry + kRowStep * i) * kPStride + kk, pv[i]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* v_row = s_v + (kk + u) * D + kx * kW;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          float vv[kW];
          load_vec<kW>(v_row + kKeyThreads * kW * g, vv);
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int w = 0; w < kW; ++w)
              acc[i][g * kW + w] = fmaf(pv[i][u], vv[w], acc[i][g * kW + w]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int q_pos = q0 + ry + kRowStep * i;
    if (q_pos < Lq) {
      const float denom = fmaxf(l[i], 1e-30f);
      float* o_row = o + (static_cast<size_t>(bh) * Lq + q_pos) * D + kx * kW;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        float out[kW];
#pragma unroll
        for (int w = 0; w < kW; ++w) out[w] = acc[i][g * kW + w] / denom;
        store_vec<kW>(o_row + kKeyThreads * kW * g, out);
      }
    }
  }
}

// The passes path: one block per (query tile, batch * head, pass), block
// index (q_tiles - 1 - q_tile) * BH * passes + bh * passes + pass.
__global__ void __launch_bounds__(kWThreads, kWMinBlocks)
    flash_attention_wide_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                float* __restrict__ o, int BH, int Lq, int Lk,
                                int D, int q_tiles, int passes, int causal,
                                float qscale) {
  constexpr int kKeysT = kWKeys / kKeyThreads;  // keys a thread: 4
  constexpr int kColsT = kWCols / kKeyThreads;  // O columns a thread: 16
  __shared__ float s_q[kWRows][kWChunk + 1];  // pre-scaled
  __shared__ float s_k[kWKeys][kWChunk + 1];
  __shared__ float s_v[kWKeys][kWCols];
  __shared__ float s_p[kWRows][kWKeys + 1];

  const int tid = threadIdx.x;
  const int kx = tid % kKeyThreads;
  const int ry = tid / kKeyThreads;
  size_t blk = blockIdx.x;
  const int pass = static_cast<int>(blk % passes);
  blk /= passes;
  const int bh = static_cast<int>(blk % BH);
  const int q_tile = q_tiles - 1 - static_cast<int>(blk / BH);
  const int q0 = q_tile * kWRows;
  const int c0 = pass * kWCols;
  const int q_pos = q0 + ry;
  const float* q_bh = q + static_cast<size_t>(bh) * Lq * D;
  const float* k_bh = k + static_cast<size_t>(bh) * Lk * D;
  const float* v_bh = v + static_cast<size_t>(bh) * Lk * D;

  float m = kNegBig, l = 0.f, acc[kColsT];
#pragma unroll
  for (int c = 0; c < kColsT; ++c) acc[c] = 0.f;
  const int n_kv = (Lk + kWKeys - 1) / kWKeys;
  const int hi = causal ? min((q0 + kWRows + kWKeys - 1) / kWKeys, n_kv) : n_kv;

  for (int j = 0; j < hi; ++j) {
    const int k0 = j * kWKeys;
    __syncthreads();  // every thread is done with the last tile's V and P
    for (int e = tid; e < kWKeys * kWCols; e += kWThreads) {
      const int r = e / kWCols, c = e - r * kWCols;
      const bool in = k0 + r < Lk && c0 + c < D;
      s_v[r][c] = in ? v_bh[static_cast<size_t>(k0 + r) * D + c0 + c] : 0.f;
    }
    float s[kKeysT];
#pragma unroll
    for (int t = 0; t < kKeysT; ++t) s[t] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kWChunk) {
      if (d0 > 0) __syncthreads();  // the last chunk is read
      for (int e = tid; e < kWRows * kWChunk; e += kWThreads) {
        const int r = e / kWChunk, c = e - r * kWChunk;
        const bool qin = q0 + r < Lq && d0 + c < D;
        s_q[r][c] = qin ? q_bh[static_cast<size_t>(q0 + r) * D + d0 + c] * qscale : 0.f;
        const bool kin = k0 + r < Lk && d0 + c < D;
        s_k[r][c] = kin ? k_bh[static_cast<size_t>(k0 + r) * D + d0 + c] : 0.f;
      }
      __syncthreads();
      const int width = min(kWChunk, D - d0);
      for (int c = 0; c < width; ++c) {
        const float qv = s_q[ry][c];
#pragma unroll
        for (int t = 0; t < kKeysT; ++t) s[t] = fmaf(qv, s_k[kx + kKeyThreads * t][c], s[t]);
      }
    }
    float mx = kNegBig;
#pragma unroll
    for (int t = 0; t < kKeysT; ++t) {
      const int k_pos = k0 + kx + kKeyThreads * t;
      const bool keep = k_pos < Lk && (!causal || q_pos >= k_pos);
      s[t] = keep ? s[t] : kNegBig;
      mx = fmaxf(mx, s[t]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kKeysT; ++t) {
      const float p = expf(s[t] - m_new);
      s_p[ry][kx + kKeyThreads * t] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    l = fmaf(l, corr, sum);
    m = m_new;
#pragma unroll
    for (int c = 0; c < kColsT; ++c) acc[c] *= corr;
    __syncwarp();  // a row's probabilities are written and read by one warp
    for (int kk = 0; kk < kWKeys; ++kk) {
      const float p = s_p[ry][kk];
#pragma unroll
      for (int c = 0; c < kColsT; ++c) acc[c] = fmaf(p, s_v[kk][kx + kKeyThreads * c], acc[c]);
    }
  }

  if (q_pos < Lq) {
    const float denom = fmaxf(l, 1e-30f);
    float* o_row = o + (static_cast<size_t>(bh) * Lq + q_pos) * D;
#pragma unroll
    for (int c = 0; c < kColsT; ++c) {
      const int col = c0 + kx + kKeyThreads * c;
      if (col < D) o_row[col] = acc[c] / denom;
    }
  }
}

// The resident path's shared row width: D rounded up to 8 floats (zeros past
// D), so that a row of D + kPad floats is an odd number of 16-byte groups.
__host__ __device__ constexpr int res_width(int d) { return (d + 7) / 8 * 8; }

// Floats of shared memory of a resident-path block: the Q tile and the K tile
// [64][res_width + kPad], the V tile [64][res_width], the probabilities
// [64][kRPStride], and two [64] row vectors (the rescale factor and l).
__host__ __device__ constexpr int res_smem_floats(int d) {
  return (kRRows + kRKeys) * (res_width(d) + kPad) + kRKeys * res_width(d) +
         kRRows * kRPStride + 2 * kRRows;
}

// O's float4 column groups a thread owns on the resident path (16 threads
// share a row): the instantiation that takes head width d.
__host__ __device__ constexpr int res_groups(int d) { return ((d + 3) / 4 + 15) / 16; }

// One 4-byte cp.async (L1 and L2); with `valid` false it writes a zero.
__device__ __forceinline__ void copy4(float* dst, const float* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Starts the copy of `rows` rows of a device array of row stride D (row r at
// src + r * D) into shared rows of `stride` floats, `width` columns each (a
// multiple of 8): zeros at or past `valid` rows and at or past column `lim`.
// 16-byte copies when `vec` (D a multiple of 4 and the array 16-byte
// aligned), else 4-byte ones. The block's kThreads threads share the copies.
template <int kThreads>
__device__ __forceinline__ void slice_copy(const float* __restrict__ src, float* dst,
                                           int rows, int stride, int valid, int D, int width,
                                           int lim, bool vec, int tid) {
  if (vec) {
    for (int e = tid; e < rows * (width / 4); e += kThreads) {
      const int r = e / (width / 4), c = (e % (width / 4)) * 4;
      const bool in = r < valid && c < lim;
      copy16(dst + r * stride + c, in ? src + static_cast<size_t>(r) * D + c : src, in);
    }
  } else {
    for (int e = tid; e < rows * width; e += kThreads) {
      const int r = e / width, c = e % width;
      const bool in = r < valid && c < lim;
      copy4(dst + r * stride + c, in ? src + static_cast<size_t>(r) * D + c : src, in);
    }
  }
}

// slice_copy of whole rows of a [*, D] device array: res_width(D) columns,
// zeros past D.
template <int kThreads = kRThreads>
__device__ __forceinline__ void res_copy(const float* __restrict__ src, float* dst,
                                         int rows, int stride, int valid, int D,
                                         bool vec, int tid) {
  slice_copy<kThreads>(src, dst, rows, stride, valid, D, res_width(D), D, vec, tid);
}

// Scales the `width` columns of the kRRows rows of a Q tile that this thread
// copied (slice_copy's split of the work among kThreads threads) by
// `qscale`, after its copies have landed.
template <int kThreads>
__device__ __forceinline__ void slice_scale(float* s_q, int stride, int width, bool vec,
                                            float qscale, int tid) {
  if (vec) {
    for (int e = tid; e < kRRows * (width / 4); e += kThreads) {
      float4* x = reinterpret_cast<float4*>(s_q + (e / (width / 4)) * stride + (e % (width / 4)) * 4);
      x->x *= qscale; x->y *= qscale; x->z *= qscale; x->w *= qscale;
    }
  } else {
    for (int e = tid; e < kRRows * width; e += kThreads) {
      s_q[(e / width) * stride + e % width] *= qscale;
    }
  }
}

// slice_scale of a Q tile of whole rows (res_copy's).
template <int kThreads = kRThreads>
__device__ __forceinline__ void res_scale(float* s_q, int stride, int D, bool vec,
                                          float qscale, int tid) {
  slice_scale<kThreads>(s_q, stride, res_width(D), vec, qscale, tid);
}

// The resident path: one block per (query tile of kRRows, batch * head),
// heaviest query tiles first (block b takes query tile q_tiles - 1 - b / BH
// of head b % BH), taking all of D. G = res_groups(D) sizes O's registers.
template <int G>
__global__ void __launch_bounds__(kRThreads, 1)
    flash_attention_resident_kernel(const float* __restrict__ q,
                                    const float* __restrict__ k,
                                    const float* __restrict__ v,
                                    float* __restrict__ o, int BH, int Lq, int Lk,
                                    int D, int q_tiles, int causal, int vec,
                                    float qscale) {
  const int w = res_width(D), ds = w + kPad;
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                          // [kRRows][ds], pre-scaled
  float* s_k = s_q + kRRows * ds;             // [kRKeys][ds]
  float* s_v = s_k + kRKeys * ds;             // [kRKeys][w]
  float* s_p = s_v + kRKeys * w;              // [kRRows][kRPStride]
  float* s_corr = s_p + kRRows * kRPStride;   // [kRRows]: this tile's rescale
  float* s_l = s_corr + kRRows;               // [kRRows]: l after the last tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // S: warp w owns rows 8w .. 8w + 7; the thread (h, kx) = (lane / 16, lane %
  // 16) rows s_row0 + i and keys kx + 16 t, so a row sits in one half-warp
  const int kx = lane & 15;
  const int s_row0 = warp * 8 + (lane >> 4) * 4;
  // O: rows pr + 16 i and float4 column groups cx + 16 g; a warp takes 8 rows
  // (one 16-byte probability load of 8 distinct rows) by 4 column groups (one
  // 64-byte run of a V row)
  const int pr = (warp >> 2) * 8 + (lane >> 2);
  const int cx = (warp & 3) * 4 + (lane & 3);
  const int bh = static_cast<int>(blockIdx.x % static_cast<unsigned>(BH));
  const int q_tile = q_tiles - 1 - static_cast<int>(blockIdx.x / static_cast<unsigned>(BH));
  const int q0 = q_tile * kRRows;
  const float* q_bh = q + static_cast<size_t>(bh) * Lq * D;
  const float* k_bh = k + static_cast<size_t>(bh) * Lk * D;
  const float* v_bh = v + static_cast<size_t>(bh) * Lk * D;

  float m[4], l[4];
  float4 acc[4][G];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) acc[i][g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int n_kv = (Lk + kRKeys - 1) / kRKeys;
  const int hi = causal ? min((q0 + kRRows + kRKeys - 1) / kRKeys, n_kv) : n_kv;

  // the Q tile and key tile 0 in flight together
  res_copy(q_bh + static_cast<size_t>(q0) * D, s_q, kRRows, ds, Lq - q0, D, vec, tid);
  res_copy(k_bh, s_k, kRKeys, ds, Lk, D, vec, tid);
  copies_commit();
  for (int j = 0; j < hi; ++j) {
    const int k0 = j * kRKeys;
    copies_wait();  // this thread's copies of K tile j (and at j = 0 of Q) landed
    if (j == 0) res_scale(s_q, ds, D, vec, qscale, tid);
    // K tile j is visible to every thread, and every thread is done with
    // tile j - 1's V and P: V tile j is copied while QK^T of tile j runs
    __syncthreads();
    res_copy(v_bh + static_cast<size_t>(k0) * D, s_v, kRKeys, w, Lk - k0, D, vec, tid);
    copies_commit();

    // S = Q K^T, 4 rows x 4 keys a thread, each score one FMA chain over D
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t) s[i][t] = 0.f;
#pragma unroll 2
    for (int c = 0; c < w; c += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(s_q + (s_row0 + i) * ds + c);
#pragma unroll
      for (int t = 0; t < 4; ++t)
        kv[t] = *reinterpret_cast<const float4*>(s_k + (kx + 16 * t) * ds + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          s[i][t] = fmaf(qv[i].x, kv[t].x, s[i][t]);
          s[i][t] = fmaf(qv[i].y, kv[t].y, s[i][t]);
          s[i][t] = fmaf(qv[i].z, kv[t].z, s[i][t]);
          s[i][t] = fmaf(qv[i].w, kv[t].w, s[i][t]);
        }
    }
    // the masks, the row's max and sum over its 16 threads (a fixed order:
    // a thread's keys in t order, then four xor shuffles), p to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + s_row0 + i;
      float mx = kNegBig;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int k_pos = k0 + kx + 16 * t;
        const bool keep = k_pos < Lk && (!causal || q_pos >= k_pos);
        s[i][t] = keep ? s[i][t] : kNegBig;
        mx = fmaxf(mx, s[i][t]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float* p_row = s_p + (s_row0 + i) * kRPStride + kx;
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float p = expf(s[i][t] - m_new);
        p_row[16 * t] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      sum += __shfl_xor_sync(0xffffffffu, sum, 8);
      l[i] = fmaf(l[i], corr, sum);
      m[i] = m_new;
      if (kx == 0) s_corr[s_row0 + i] = corr;
    }
    copies_wait();  // this thread's copies of V tile j landed
    // P, the rescale factors and V tile j are visible to every warp, and
    // every thread is done with K tile j: K tile j + 1 is copied while PV of
    // tile j runs
    __syncthreads();
    if (j + 1 < hi) {
      res_copy(k_bh + static_cast<size_t>(k0 + kRKeys) * D, s_k, kRKeys, ds,
               Lk - k0 - kRKeys, D, vec, tid);
      copies_commit();
    }

    // O = corr * O + P V, 4 rows x G float4 columns a thread, keys ascending.
    // Every column group runs, also one that starts at or past D: a branch
    // around each group's load left its latency exposed (PV 1.5x slower on
    // the card); such a group reads zeros or a neighbouring row inside
    // shared memory, and is never stored.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = s_corr[pr + 16 * i];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        acc[i][g].x *= corr; acc[i][g].y *= corr; acc[i][g].z *= corr; acc[i][g].w *= corr;
      }
    }
#pragma unroll 2
    for (int kk = 0; kk < kRKeys; kk += 4) {
      float pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_vec<4>(s_p + (pr + 16 * i) * kRPStride + kk, pv[i]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* v_row = s_v + (kk + u) * w + 4 * cx;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(v_row + 64 * g);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][g].x = fmaf(pv[i][u], vv.x, acc[i][g].x);
            acc[i][g].y = fmaf(pv[i][u], vv.y, acc[i][g].y);
            acc[i][g].z = fmaf(pv[i][u], vv.z, acc[i][g].z);
            acc[i][g].w = fmaf(pv[i][u], vv.w, acc[i][g].w);
          }
        }
      }
    }
  }

  if (kx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s_l[s_row0 + i] = l[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q_pos = q0 + pr + 16 * i;
    if (q_pos >= Lq) continue;
    const float denom = fmaxf(s_l[pr + 16 * i], 1e-30f);
    float* o_row = o + (static_cast<size_t>(bh) * Lq + q_pos) * D;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int c = 4 * (cx + 16 * g);
      if (c >= D) continue;
      const float out[4] = {acc[i][g].x / denom, acc[i][g].y / denom, acc[i][g].z / denom,
                            acc[i][g].w / denom};
      if (vec) {
        store_vec<4>(o_row + c, out);
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (c + x < D) o_row[c + x] = out[x];
      }
    }
  }
}

template <int G>
int launch_resident(const float* q, const float* k, const float* v, float* o, int BH,
                    int Lq, int Lk, int D, int causal, int vec, int blocks, int smem,
                    float qscale, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_resident_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_resident_kernel<G><<<blocks, kRThreads, smem, stream>>>(
      q, k, v, o, BH, Lq, Lk, D, (Lq + kRRows - 1) / kRRows, causal, vec, qscale);
  return static_cast<int>(cudaGetLastError());
}

// the resident path's instantiations, G = 3, 4, 5 (D up to 192, 256, kRMaxD)
constexpr int kRGroupsMin = 3, kRGroupsMax = 5;
using ResLaunchFn = int (*)(const float*, const float*, const float*, float*, int, int,
                            int, int, int, int, int, int, float, cudaStream_t);
const ResLaunchFn kResLaunch[] = {launch_resident<3>, launch_resident<4>, launch_resident<5>};
const void* const kResKernels[] = {
    reinterpret_cast<const void*>(flash_attention_resident_kernel<3>),
    reinterpret_cast<const void*>(flash_attention_resident_kernel<4>),
    reinterpret_cast<const void*>(flash_attention_resident_kernel<5>),
};
static_assert(res_groups(kMaxD + 1) == kRGroupsMin && res_groups(kRMaxD) == kRGroupsMax &&
                  sizeof(kResLaunch) / sizeof(kResLaunch[0]) == kRGroupsMax - kRGroupsMin + 1,
              "one instantiation per G from D = kMaxD + 1 to kRMaxD");
static_assert(res_smem_floats(kRMaxD) * 4 <= kMaxSmem &&
                  res_smem_floats(kRMaxD + 8) * 4 > kMaxSmem,
              "kRMaxD is the widest head whose resident tiles fit a block");

// Floats of shared memory of a streamed-path block: the Q tile [64][res_width
// + kPad], kSStages chunk buffers [64][kSCStride] that K's and V's column
// chunks take in turn, the probabilities [64][kRPStride], and two [64] row
// vectors (the rescale factor and l).
__host__ __device__ constexpr int str_smem_floats(int d) {
  return kSRows * (res_width(d) + kPad) + kSStages * kSKeys * kSCStride +
         kSRows * kRPStride + 2 * kSRows;
}

// Waits until at most N of this thread's groups of copies are in flight.
template <int N>
__device__ __forceinline__ void copies_wait_until() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copy of one column chunk of a key tile: columns c0 .. c0 +
// kChunk - 1 of the kSKeys rows of a device array of row stride D (row r at
// src + r * D) into shared rows of kStride floats, zeros at or past `valid`
// rows and at or past column `lim`, shared by the block's kThreads threads.
// 16-byte copies when `vec`, else 4-byte ones.
template <int kChunk, int kStride, int kThreads>
__device__ __forceinline__ void slice_chunk_copy(const float* __restrict__ src, float* dst,
                                                 int valid, int c0, int D, int lim, bool vec,
                                                 int tid) {
  if (vec) {
#pragma unroll
    for (int x = 0; x < kSKeys * kChunk / 4 / kThreads; ++x) {
      const int e = tid + x * kThreads;
      const int r = e / (kChunk / 4), c = (e % (kChunk / 4)) * 4;
      const bool in = r < valid && c0 + c < lim;
      copy16(dst + r * kStride + c, in ? src + static_cast<size_t>(r) * D + c0 + c : src,
             in);
    }
  } else {
#pragma unroll 4
    for (int x = 0; x < kSKeys * kChunk / kThreads; ++x) {
      const int e = tid + x * kThreads;
      const int r = e / kChunk, c = e % kChunk;
      const bool in = r < valid && c0 + c < lim;
      copy4(dst + r * kStride + c, in ? src + static_cast<size_t>(r) * D + c0 + c : src, in);
    }
  }
}

// slice_chunk_copy of a [*, D] device array's rows, zeros past D.
template <int kChunk = kSChunk, int kStride = kSCStride, int kThreads = kSThreads>
__device__ __forceinline__ void chunk_copy(const float* __restrict__ src, float* dst,
                                           int valid, int c0, int D, bool vec, int tid) {
  slice_chunk_copy<kChunk, kStride, kThreads>(src, dst, valid, c0, D, D, vec, tid);
}

// The streamed path: one block per (query tile of kSRows, batch * head),
// heaviest query tiles first, taking all of D with the resident path's
// thread maps and arithmetic. A key tile is walked as a sequence of chunks:
// K's nc column chunks (S summed over them in ascending D), then V's nc
// (chunk g feeds O's column group g). G sizes O's registers.
template <int G>
__global__ void __launch_bounds__(kSThreads, 1)
    flash_attention_streamed_kernel(const float* __restrict__ q,
                                    const float* __restrict__ k,
                                    const float* __restrict__ v,
                                    float* __restrict__ o, int BH, int Lq, int Lk,
                                    int D, int q_tiles, int causal, int vec,
                                    float qscale) {
  const int w = res_width(D), ds = w + kPad;
  const int nc = (w + kSChunk - 1) / kSChunk;  // column chunks of K, and of V, a tile
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                                 // [kSRows][ds], pre-scaled
  float* s_c = s_q + kSRows * ds;                    // kSStages x [kSKeys][kSCStride]
  float* s_p = s_c + kSStages * kSKeys * kSCStride;  // [kSRows][kRPStride]
  float* s_corr = s_p + kSRows * kRPStride;          // [kSRows]: this tile's rescale
  float* s_l = s_corr + kSRows;                      // [kSRows]: l after the last tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the resident path's maps: S rows s_row0 + i, keys kx + 16 t (a row in one
  // half-warp); O rows pr + 16 i, float4 column groups cx + 16 g
  const int kx = lane & 15;
  const int s_row0 = warp * 8 + (lane >> 4) * 4;
  const int pr = (warp >> 2) * 8 + (lane >> 2);
  const int cx = (warp & 3) * 4 + (lane & 3);
  const int bh = static_cast<int>(blockIdx.x % static_cast<unsigned>(BH));
  const int q_tile = q_tiles - 1 - static_cast<int>(blockIdx.x / static_cast<unsigned>(BH));
  const int q0 = q_tile * kSRows;
  const float* q_bh = q + static_cast<size_t>(bh) * Lq * D;
  const float* k_bh = k + static_cast<size_t>(bh) * Lk * D;
  const float* v_bh = v + static_cast<size_t>(bh) * Lk * D;

  float m[4], l[4];
  float4 acc[4][G];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) acc[i][g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int n_kv = (Lk + kSKeys - 1) / kSKeys;
  const int hi = causal ? min((q0 + kSRows + kSKeys - 1) / kSKeys, n_kv) : n_kv;
  const int steps = 2 * nc;  // a key tile's chunks: K's nc, then V's nc
  const int total = hi * steps;

  // Starts the copy of chunk n of the block's sequence into its buffer (none
  // past the last) and commits it as one group.
  const auto issue = [&](int n) {
    if (n < total) {
      const int j = n / steps, r = n - j * steps;
      const int k0 = j * kSKeys;
      const bool is_k = r < nc;
      chunk_copy((is_k ? k_bh : v_bh) + static_cast<size_t>(k0) * D,
                 s_c + (n % kSStages) * (kSKeys * kSCStride), Lk - k0,
                 (is_k ? r : r - nc) * kSChunk, D, vec != 0, tid);
    }
    copies_commit();
  };
  // Returns chunk n's buffer once every thread can read it (at n = 0 the Q
  // tile too, scaled), and starts the copy of chunk n + kSStages - 1 into
  // the buffer that chunk n - 1 used.
  const auto next_chunk = [&](int n) -> const float* {
    copies_wait_until<kSStages - 2>();  // this thread's copies of chunk n (and Q) landed
    if (n == 0) res_scale(s_q, ds, D, vec, qscale, tid);
    // chunk n is visible to every thread, and every thread is done with
    // chunk n - 1
    __syncthreads();
    issue(n + kSStages - 1);
    return s_c + (n % kSStages) * (kSKeys * kSCStride);
  };

  // the Q tile and the first kSStages - 1 chunks in flight, Q with chunk 0
  res_copy(q_bh + static_cast<size_t>(q0) * D, s_q, kSRows, ds, Lq - q0, D, vec, tid);
#pragma unroll
  for (int n = 0; n < kSStages - 1; ++n) issue(n);
  for (int j = 0; j < hi; ++j) {
    const int k0 = j * kSKeys, n0 = j * steps;
    // S = Q K^T, 4 rows x 4 keys a thread, each score one FMA chain over D
    // ascending, continued from chunk to chunk
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t) s[i][t] = 0.f;
    for (int c = 0; c < nc; ++c) {
      const float* s_k = next_chunk(n0 + c);
      const float* q_c = s_q + c * kSChunk;
      const int cw = min(kSChunk, w - c * kSChunk);
#pragma unroll 2
      for (int x = 0; x < cw; x += 4) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(q_c + (s_row0 + i) * ds + x);
#pragma unroll
        for (int t = 0; t < 4; ++t)
          kv[t] = *reinterpret_cast<const float4*>(s_k + (kx + 16 * t) * kSCStride + x);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            s[i][t] = fmaf(qv[i].x, kv[t].x, s[i][t]);
            s[i][t] = fmaf(qv[i].y, kv[t].y, s[i][t]);
            s[i][t] = fmaf(qv[i].z, kv[t].z, s[i][t]);
            s[i][t] = fmaf(qv[i].w, kv[t].w, s[i][t]);
          }
      }
    }
    // the masks, the row's max and sum over its 16 threads (a thread's keys
    // in t order, then four xor shuffles), p to shared memory: as the
    // resident path
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + s_row0 + i;
      float mx = kNegBig;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int k_pos = k0 + kx + 16 * t;
        const bool keep = k_pos < Lk && (!causal || q_pos >= k_pos);
        s[i][t] = keep ? s[i][t] : kNegBig;
        mx = fmaxf(mx, s[i][t]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float* p_row = s_p + (s_row0 + i) * kRPStride + kx;
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float p = expf(s[i][t] - m_new);
        p_row[16 * t] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      sum += __shfl_xor_sync(0xffffffffu, sum, 8);
      l[i] = fmaf(l[i], corr, sum);
      m[i] = m_new;
      if (kx == 0) s_corr[s_row0 + i] = corr;
    }

    // O = corr * O + P V, 4 rows x one float4 of column group g a thread from
    // V's chunk g, keys ascending. The first chunk's barrier also makes P and
    // the rescale factors visible to every warp.
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= nc) break;
      const float* s_v = next_chunk(n0 + nc + g);
      if (g == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float corr = s_corr[pr + 16 * i];
#pragma unroll
          for (int h = 0; h < G; ++h) {
            acc[i][h].x *= corr; acc[i][h].y *= corr; acc[i][h].z *= corr; acc[i][h].w *= corr;
          }
        }
      }
#pragma unroll 2
      for (int kk = 0; kk < kSKeys; kk += 4) {
        float pv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) load_vec<4>(s_p + (pr + 16 * i) * kRPStride + kk, pv[i]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 vv = *reinterpret_cast<const float4*>(s_v + (kk + u) * kSCStride + 4 * cx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][g].x = fmaf(pv[i][u], vv.x, acc[i][g].x);
            acc[i][g].y = fmaf(pv[i][u], vv.y, acc[i][g].y);
            acc[i][g].z = fmaf(pv[i][u], vv.z, acc[i][g].z);
            acc[i][g].w = fmaf(pv[i][u], vv.w, acc[i][g].w);
          }
        }
      }
    }
  }

  if (kx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s_l[s_row0 + i] = l[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q_pos = q0 + pr + 16 * i;
    if (q_pos >= Lq) continue;
    const float denom = fmaxf(s_l[pr + 16 * i], 1e-30f);
    float* o_row = o + (static_cast<size_t>(bh) * Lq + q_pos) * D;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int c = 4 * (cx + 16 * g);
      if (c >= D) continue;
      const float out[4] = {acc[i][g].x / denom, acc[i][g].y / denom, acc[i][g].z / denom,
                            acc[i][g].w / denom};
      if (vec) {
        store_vec<4>(o_row + c, out);
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (c + x < D) o_row[c + x] = out[x];
      }
    }
  }
}

static_assert(kSRows == kRRows && kSThreads == kRThreads,
              "the streamed path copies and scales its Q tile as the resident path does");
static_assert(kSKeys * kSChunk % (4 * kSThreads) == 0 && kSCStride % 8 == 4,
              "a chunk is whole 16-byte copies a thread; a chunk row is an odd number of "
              "16-byte groups");
static_assert(str_smem_floats(kSMaxD) * 4 <= kMaxSmem && res_groups(kSMaxD) == kSGroups &&
                  res_groups(kSMaxD + 8) > kSGroups && kSGroups * 64 >= kSMaxD,
              "kSMaxD is the widest head of the streamed path's register plan, and its "
              "tiles fit a block");

// Floats of shared memory of a wide-streamed-path block: the Q tile
// [64][res_width + kPad], kWSStages chunk buffers that K's [64][kWSKStride]
// and V's [64][kWSVStride] column chunks take in turn, the probabilities
// [64][kRPStride], and two [64] row vectors (the rescale factor and l).
__host__ __device__ constexpr int ws_buffer_floats() {
  return kWSKeys * (kWSKStride > kWSVStride ? kWSKStride : kWSVStride);
}
__host__ __device__ constexpr int ws_smem_floats(int d) {
  return kWSRows * (res_width(d) + kPad) + kWSStages * ws_buffer_floats() +
         kWSRows * kRPStride + 2 * kWSRows;
}

// The wide streamed path: one block per (query tile of kWSRows, batch * head),
// heaviest query tiles first, taking all of D. A key tile is walked as a
// sequence of chunks: K's nk column chunks of kWSKChunk (S summed over them
// in ascending D), then V's nv of kWSVChunk (O's column group g from the
// chunk that holds columns 64 g .. 64 g + 63). G sizes O's registers.
template <int G>
__global__ void __launch_bounds__(kWSThreads, 1)
    flash_attention_wide_streamed_kernel(const float* __restrict__ q,
                                         const float* __restrict__ k,
                                         const float* __restrict__ v,
                                         float* __restrict__ o, int BH, int Lq, int Lk,
                                         int D, int q_tiles, int causal, int vec,
                                         float qscale) {
  constexpr int kGroupsPerV = kWSVChunk / 64;  // O's column groups a V chunk feeds
  const int w = res_width(D), ds = w + kPad;
  const int nk = (w + kWSKChunk - 1) / kWSKChunk;  // K's column chunks a tile
  const int nv = (w + kWSVChunk - 1) / kWSVChunk;  // V's column chunks a tile
  const int ng = (w + 63) / 64;                    // O's column groups that hold a column
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                                 // [kWSRows][ds], pre-scaled
  float* s_c = s_q + kWSRows * ds;                   // kWSStages chunk buffers
  float* s_p = s_c + kWSStages * ws_buffer_floats();  // [kWSRows][kRPStride]
  float* s_corr = s_p + kWSRows * kRPStride;         // [kWSRows]: this tile's rescale
  float* s_l = s_corr + kWSRows;                     // [kWSRows]: l after the last tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // S: rows s_row0 + i (i < 2) and keys kx + 16 t, a row in one half-warp,
  // a warp four rows
  const int kx = lane & 15;
  const int s_row0 = 2 * (tid >> 4);
  // O: rows pr + 32 i and float4 column groups cx + 16 g; a warp takes 8 rows
  // (one 16-byte probability load of 8 distinct rows) by 4 column groups (one
  // 64-byte run of a V row)
  const int pr = (warp >> 2) * 8 + (lane >> 2);
  const int cx = (warp & 3) * 4 + (lane & 3);
  const int bh = static_cast<int>(blockIdx.x % static_cast<unsigned>(BH));
  const int q_tile = q_tiles - 1 - static_cast<int>(blockIdx.x / static_cast<unsigned>(BH));
  const int q0 = q_tile * kWSRows;
  const float* q_bh = q + static_cast<size_t>(bh) * Lq * D;
  const float* k_bh = k + static_cast<size_t>(bh) * Lk * D;
  const float* v_bh = v + static_cast<size_t>(bh) * Lk * D;

  float m[2], l[2];
  float4 acc[2][G];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) acc[i][g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int n_kv = (Lk + kWSKeys - 1) / kWSKeys;
  const int hi = causal ? min((q0 + kWSRows + kWSKeys - 1) / kWSKeys, n_kv) : n_kv;
  const int steps = nk + nv;  // a key tile's chunks: K's nk, then V's nv
  const int total = hi * steps;

  // Starts the copy of chunk n of the block's sequence into its buffer (none
  // past the last) and commits it as one group.
  const auto issue = [&](int n) {
    if (n < total) {
      const int j = n / steps, r = n - j * steps;
      const size_t k0 = static_cast<size_t>(j) * kWSKeys;
      float* buf = s_c + (n % kWSStages) * ws_buffer_floats();
      if (r < nk) {
        chunk_copy<kWSKChunk, kWSKStride, kWSThreads>(k_bh + k0 * D, buf, Lk - j * kWSKeys,
                                                      r * kWSKChunk, D, vec != 0, tid);
      } else {
        chunk_copy<kWSVChunk, kWSVStride, kWSThreads>(v_bh + k0 * D, buf, Lk - j * kWSKeys,
                                                      (r - nk) * kWSVChunk, D, vec != 0, tid);
      }
    }
    copies_commit();
  };
  // Returns chunk n's buffer once every thread can read it (at n = 0 the Q
  // tile too, scaled), and starts the copy of chunk n + kWSStages - 1 into
  // the buffer that chunk n - 1 used.
  const auto next_chunk = [&](int n) -> const float* {
    copies_wait_until<kWSStages - 2>();  // this thread's copies of chunk n (and Q) landed
    if (n == 0) res_scale<kWSThreads>(s_q, ds, D, vec, qscale, tid);
    // chunk n is visible to every thread, and every thread is done with
    // chunk n - 1
    __syncthreads();
    issue(n + kWSStages - 1);
    return s_c + (n % kWSStages) * ws_buffer_floats();
  };

  // the Q tile and the first kWSStages - 1 chunks in flight, Q with chunk 0
  res_copy<kWSThreads>(q_bh + static_cast<size_t>(q0) * D, s_q, kWSRows, ds, Lq - q0, D,
                       vec, tid);
#pragma unroll
  for (int n = 0; n < kWSStages - 1; ++n) issue(n);
  for (int j = 0; j < hi; ++j) {
    const int k0 = j * kWSKeys, n0 = j * steps;
    // S = Q K^T, 2 rows x 4 keys a thread, each score one FMA chain over D
    // ascending, continued from chunk to chunk
    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t) s[i][t] = 0.f;
    for (int c = 0; c < nk; ++c) {
      const float* s_k = next_chunk(n0 + c);
      const float* q_c = s_q + c * kWSKChunk;
      const int cw = min(kWSKChunk, w - c * kWSKChunk);
#pragma unroll 2
      for (int x = 0; x < cw; x += 4) {
        float4 qv[2], kv[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          qv[i] = *reinterpret_cast<const float4*>(q_c + (s_row0 + i) * ds + x);
#pragma unroll
        for (int t = 0; t < 4; ++t)
          kv[t] = *reinterpret_cast<const float4*>(s_k + (kx + 16 * t) * kWSKStride + x);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            s[i][t] = fmaf(qv[i].x, kv[t].x, s[i][t]);
            s[i][t] = fmaf(qv[i].y, kv[t].y, s[i][t]);
            s[i][t] = fmaf(qv[i].z, kv[t].z, s[i][t]);
            s[i][t] = fmaf(qv[i].w, kv[t].w, s[i][t]);
          }
      }
    }
    // the masks, the row's max and sum over its 16 threads (a thread's keys
    // in t order, then four xor shuffles), p to shared memory: as the
    // streamed path
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q_pos = q0 + s_row0 + i;
      float mx = kNegBig;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int k_pos = k0 + kx + 16 * t;
        const bool keep = k_pos < Lk && (!causal || q_pos >= k_pos);
        s[i][t] = keep ? s[i][t] : kNegBig;
        mx = fmaxf(mx, s[i][t]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float* p_row = s_p + (s_row0 + i) * kRPStride + kx;
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float p = expf(s[i][t] - m_new);
        p_row[16 * t] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      sum += __shfl_xor_sync(0xffffffffu, sum, 8);
      l[i] = fmaf(l[i], corr, sum);
      m[i] = m_new;
      if (kx == 0) s_corr[s_row0 + i] = corr;
    }

    // O = corr * O + P V, 2 rows x one float4 of each of the chunk's column
    // groups a thread from V's chunk, keys ascending, each probability
    // loaded once for all of the chunk's groups. The first V chunk's barrier
    // also makes P and the rescale factors visible to every warp.
#pragma unroll
    for (int g0 = 0; g0 < G; g0 += kGroupsPerV) {
      if (g0 >= ng) break;
      const float* s_v = next_chunk(n0 + nk + g0 / kGroupsPerV) + 4 * cx;
      if (g0 == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float corr = s_corr[pr + 32 * i];
#pragma unroll
          for (int h = 0; h < G; ++h) {
            acc[i][h].x *= corr; acc[i][h].y *= corr; acc[i][h].z *= corr; acc[i][h].w *= corr;
          }
        }
      }
#pragma unroll 2
      for (int kk = 0; kk < kWSKeys; kk += 4) {
        float pv[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) load_vec<4>(s_p + (pr + 32 * i) * kRPStride + kk, pv[i]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int gg = 0; gg < kGroupsPerV; ++gg) {
            const int g = g0 + gg;
            const float4 vv =
                *reinterpret_cast<const float4*>(s_v + (kk + u) * kWSVStride + 64 * gg);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              acc[i][g].x = fmaf(pv[i][u], vv.x, acc[i][g].x);
              acc[i][g].y = fmaf(pv[i][u], vv.y, acc[i][g].y);
              acc[i][g].z = fmaf(pv[i][u], vv.z, acc[i][g].z);
              acc[i][g].w = fmaf(pv[i][u], vv.w, acc[i][g].w);
            }
          }
        }
      }
    }
  }

  if (kx == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) s_l[s_row0 + i] = l[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q_pos = q0 + pr + 32 * i;
    if (q_pos >= Lq) continue;
    const float denom = fmaxf(s_l[pr + 32 * i], 1e-30f);
    float* o_row = o + (static_cast<size_t>(bh) * Lq + q_pos) * D;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int c = 4 * (cx + 16 * g);
      if (c >= D) continue;
      const float out[4] = {acc[i][g].x / denom, acc[i][g].y / denom, acc[i][g].z / denom,
                            acc[i][g].w / denom};
      if (vec) {
        store_vec<4>(o_row + c, out);
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (c + x < D) o_row[c + x] = out[x];
      }
    }
  }
}

static_assert(kWSRows == kRRows && kWSKeys == kSKeys,
              "the wide streamed path copies and scales its Q tile as the resident path "
              "does, and its chunks as the streamed path does");
static_assert(kWSKeys * kWSKChunk % (4 * kWSThreads) == 0 && kWSVChunk % 64 == 0 &&
                  kWSGroups % (kWSVChunk / 64) == 0 && kWSKStride % 8 == 4 &&
                  kWSVStride % 8 == 4,
              "a chunk is whole 16-byte copies a thread, a V chunk whole column groups of "
              "O's; a chunk row is an odd number of 16-byte groups");
static_assert(ws_smem_floats(kWSMaxD) * 4 <= kMaxSmem && kWSGroups * 64 == kWSMaxD &&
                  kWSMaxD > kSMaxD,
              "kWSMaxD is the widest head of the wide streamed path's register plan, and "
              "its tiles fit a block");

// The cluster path's slices: rank 0 takes the first cl_slice0(d) columns (D
// rounded up to 8, halved, rounded up to 8), rank 1 the rest, each a
// multiple of 8 so that a slice row of width + kPad floats is an odd number
// of 16-byte groups and a slice starts 16-byte aligned.
__host__ __device__ constexpr int cl_slice0(int d) { return (res_width(d) / 2 + 7) / 8 * 8; }
__host__ __device__ constexpr int cl_slice_width(int d, int rank) {
  return rank == 0 ? cl_slice0(d) : res_width(d) - cl_slice0(d);
}
// Floats of shared memory of a cluster-path block: a wide-streamed-path
// block's at the wider slice (rank 0's; both blocks take as much). The
// probabilities double as the exchange buffer, so there is nothing else.
__host__ __device__ constexpr int cl_smem_floats(int d) { return ws_smem_floats(cl_slice0(d)); }

// The cluster barrier split in two (sm_90): an arrive that releases this
// thread's earlier writes, shared::cluster ones included, and a wait that
// acquires every write released by the arrives of the phase it waits for.
// Every thread of both blocks takes them in turn, arrive then wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// This block's rank in its cluster, read where it is used (so that it
// holds no register across the tile loop).
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  return rank;
}
// The shared::cluster address of `p` (this block's shared memory) in the
// block of rank `rank`: the same offset in that block's shared memory.
__device__ __forceinline__ unsigned cluster_map(const float* p, unsigned rank) {
  unsigned addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))), "r"(rank));
  return addr;
}

// The cluster path: a cluster of kCBlocks blocks per (query tile of kWSRows,
// batch * head), heaviest query tiles first (cluster c takes query tile
// q_tiles - 1 - c / BH of head c % BH); block rank r is the wide streamed
// block on its slice of D (cl_slice_width(D, r) columns from r *
// cl_slice0(D)). Per key tile each block sums its slice's partial scores,
// the two blocks exchange them through distributed shared memory, and each
// takes the softmax of the sum and P V on its own columns. G sizes O's
// registers.
template <int G>
__global__ void __launch_bounds__(kWSThreads, 1)
    flash_attention_cluster_kernel(const float* __restrict__ q,
                                   const float* __restrict__ k,
                                   const float* __restrict__ v,
                                   float* __restrict__ o, int BH, int Lq, int Lk,
                                   int D, int q_tiles, int causal, int vec,
                                   float qscale) {
  constexpr int kGroupsPerV = kWSVChunk / 64;  // O's column groups a V chunk feeds
  const int rank = static_cast<int>(cluster_rank());
  const int c_base = rank * cl_slice0(D);        // the slice's first column
  const int sw = cl_slice_width(D, rank);        // its columns (zeros past D)
  const int lim = min(D - c_base, sw);           // its columns that hold data
  // rank 0's Q row stride in both blocks, so that s_p lies at one offset in
  // both and a store mapped to the partner lands in its s_p
  const int ds = cl_slice0(D) + kPad;
  const int nk = (sw + kWSKChunk - 1) / kWSKChunk;  // K's column chunks a tile
  const int nv = (sw + kWSVChunk - 1) / kWSVChunk;  // V's column chunks a tile
  const int ng = (sw + 63) / 64;                    // O's column groups that hold a column
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                                 // [kWSRows][ds], pre-scaled
  float* s_c = s_q + kWSRows * ds;                   // kWSStages chunk buffers
  float* s_p = s_c + kWSStages * ws_buffer_floats();  // [kWSRows][kRPStride]: the
                                                     // partner's partial scores, then P
  float* s_corr = s_p + kWSRows * kRPStride;         // [kWSRows]: this tile's rescale
  float* s_l = s_corr + kWSRows;                     // [kWSRows]: l after the last tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // S: rows s_row0 + i (i < 2) and keys kx + 16 t, a row in one half-warp
  const int kx = lane & 15;
  const int s_row0 = 2 * (tid >> 4);
  // O: rows pr + 32 i and float4 column groups cx + 16 g of the slice
  const int pr = (warp >> 2) * 8 + (lane >> 2);
  const int cx = (warp & 3) * 4 + (lane & 3);
  const int cl = static_cast<int>(blockIdx.x / kCBlocks);
  const int bh = static_cast<int>(cl % BH);
  const int q_tile = q_tiles - 1 - cl / BH;
  const int q0 = q_tile * kWSRows;
  const float* q_bh = q + static_cast<size_t>(bh) * Lq * D + c_base;
  const float* k_bh = k + static_cast<size_t>(bh) * Lk * D + c_base;
  const float* v_bh = v + static_cast<size_t>(bh) * Lk * D + c_base;

  float m[2], l[2];
  float4 acc[2][G];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) acc[i][g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int n_kv = (Lk + kWSKeys - 1) / kWSKeys;
  const int hi = causal ? min((q0 + kWSRows + kWSKeys - 1) / kWSKeys, n_kv) : n_kv;
  const int steps = nk + nv;  // a key tile's chunks: K's nk, then V's nv
  const int total = hi * steps;

  // Starts the copy of chunk n of the block's sequence into its buffer (none
  // past the last) and commits it as one group.
  const auto issue = [&](int n) {
    if (n < total) {
      const int j = n / steps, r = n - j * steps;
      const size_t k0 = static_cast<size_t>(j) * kWSKeys;
      float* buf = s_c + (n % kWSStages) * ws_buffer_floats();
      if (r < nk) {
        slice_chunk_copy<kWSKChunk, kWSKStride, kWSThreads>(
            k_bh + k0 * D, buf, Lk - j * kWSKeys, r * kWSKChunk, D, lim, vec != 0, tid);
      } else {
        slice_chunk_copy<kWSVChunk, kWSVStride, kWSThreads>(
            v_bh + k0 * D, buf, Lk - j * kWSKeys, (r - nk) * kWSVChunk, D, lim, vec != 0, tid);
      }
    }
    copies_commit();
  };
  // Returns chunk n's buffer once every thread can read it (at n = 0 the Q
  // slice too, scaled), and starts the copy of chunk n + kWSStages - 1 into
  // the buffer that chunk n - 1 used.
  const auto next_chunk = [&](int n) -> const float* {
    copies_wait_until<kWSStages - 2>();  // this thread's copies of chunk n (and Q) landed
    if (n == 0) slice_scale<kWSThreads>(s_q, ds, sw, vec, qscale, tid);
    // chunk n is visible to every thread, and every thread is done with
    // chunk n - 1
    __syncthreads();
    issue(n + kWSStages - 1);
    return s_c + (n % kWSStages) * ws_buffer_floats();
  };

  // the Q slice and the first kWSStages - 1 chunks in flight, Q with chunk 0
  slice_copy<kWSThreads>(q_bh + static_cast<size_t>(q0) * D, s_q, kWSRows, ds, Lq - q0, D, sw,
                         lim, vec, tid);
#pragma unroll
  for (int n = 0; n < kWSStages - 1; ++n) issue(n);
  cluster_arrive();  // this block has started (waited for before the first exchange)
  for (int j = 0; j < hi; ++j) {
    const int k0 = j * kWSKeys, n0 = j * steps;
    // the slice's partial S = Q K^T, 2 rows x 4 keys a thread, each one FMA
    // chain over the slice's columns ascending, continued from chunk to chunk
    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t) s[i][t] = 0.f;
    for (int c = 0; c < nk; ++c) {
      const float* s_k = next_chunk(n0 + c);
      const float* q_c = s_q + c * kWSKChunk;
      const int cw = min(kWSKChunk, sw - c * kWSKChunk);
#pragma unroll 2
      for (int x = 0; x < cw; x += 4) {
        float4 qv[2], kv[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          qv[i] = *reinterpret_cast<const float4*>(q_c + (s_row0 + i) * ds + x);
#pragma unroll
        for (int t = 0; t < 4; ++t)
          kv[t] = *reinterpret_cast<const float4*>(s_k + (kx + 16 * t) * kWSKStride + x);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            s[i][t] = fmaf(qv[i].x, kv[t].x, s[i][t]);
            s[i][t] = fmaf(qv[i].y, kv[t].y, s[i][t]);
            s[i][t] = fmaf(qv[i].z, kv[t].z, s[i][t]);
            s[i][t] = fmaf(qv[i].w, kv[t].w, s[i][t]);
          }
      }
    }
    // the exchange: the partner has read its s_p of the last tile (and has
    // started), this thread's partials go into it, and after the phase that
    // publishes them the partner's are added: s = s_0 + s_1 (one add, the
    // same bits in both blocks)
    cluster_wait();
    // the places the partner's thread tid reads
    const unsigned x_remote = cluster_map(s_p + s_row0 * kRPStride + kx, cluster_rank() ^ 1u);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(
                         x_remote + 4u * static_cast<unsigned>(i * kRPStride + 16 * t)),
                     "f"(s[i][t])
                     : "memory");
      }
    cluster_arrive();
    cluster_wait();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t)
        s[i][t] = __fadd_rn(s[i][t], s_p[(s_row0 + i) * kRPStride + kx + 16 * t]);
    // the masks, the row's max and sum over its 16 threads (a thread's keys
    // in t order, then four xor shuffles), p to shared memory over the
    // partials it was made from: as the wide streamed path
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q_pos = q0 + s_row0 + i;
      float mx = kNegBig;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int k_pos = k0 + kx + 16 * t;
        const bool keep = k_pos < Lk && (!causal || q_pos >= k_pos);
        s[i][t] = keep ? s[i][t] : kNegBig;
        mx = fmaxf(mx, s[i][t]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float* p_row = s_p + (s_row0 + i) * kRPStride + kx;
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float p = expf(s[i][t] - m_new);
        p_row[16 * t] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      sum += __shfl_xor_sync(0xffffffffu, sum, 8);
      l[i] = fmaf(l[i], corr, sum);
      m[i] = m_new;
      if (kx == 0) s_corr[s_row0 + i] = corr;
    }

    // O = corr * O + P V on the slice's columns, as the wide streamed path.
    // The first V chunk's barrier also makes P and the rescale factors
    // visible to every warp.
#pragma unroll
    for (int g0 = 0; g0 < G; g0 += kGroupsPerV) {
      if (g0 >= ng) break;
      const float* s_v = next_chunk(n0 + nk + g0 / kGroupsPerV) + 4 * cx;
      if (g0 == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float corr = s_corr[pr + 32 * i];
#pragma unroll
          for (int h = 0; h < G; ++h) {
            acc[i][h].x *= corr; acc[i][h].y *= corr; acc[i][h].z *= corr; acc[i][h].w *= corr;
          }
        }
      }
#pragma unroll 2
      for (int kk = 0; kk < kWSKeys; kk += 4) {
        float pv[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) load_vec<4>(s_p + (pr + 32 * i) * kRPStride + kk, pv[i]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int gg = 0; gg < kGroupsPerV; ++gg) {
            const int g = g0 + gg;
            const float4 vv =
                *reinterpret_cast<const float4*>(s_v + (kk + u) * kWSVStride + 64 * gg);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              acc[i][g].x = fmaf(pv[i][u], vv.x, acc[i][g].x);
              acc[i][g].y = fmaf(pv[i][u], vv.y, acc[i][g].y);
              acc[i][g].z = fmaf(pv[i][u], vv.z, acc[i][g].z);
              acc[i][g].w = fmaf(pv[i][u], vv.w, acc[i][g].w);
            }
          }
        }
      }
    }
    cluster_arrive();  // this thread is done with s_p for this tile
  }

  if (kx == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) s_l[s_row0 + i] = l[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q_pos = q0 + pr + 32 * i;
    if (q_pos >= Lq) continue;
    const float denom = fmaxf(s_l[pr + 32 * i], 1e-30f);
    float* o_row = o + (static_cast<size_t>(bh) * Lq + q_pos) * D +
                   static_cast<int>(cluster_rank()) * cl_slice0(D);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int c = 4 * (cx + 16 * g);
      if (c >= lim) continue;
      const float out[4] = {acc[i][g].x / denom, acc[i][g].y / denom, acc[i][g].z / denom,
                            acc[i][g].w / denom};
      if (vec) {
        store_vec<4>(o_row + c, out);
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (c + x < lim) o_row[c + x] = out[x];
      }
    }
  }
  cluster_wait();  // neither block leaves while the other may still store into it
}

static_assert(kCBlocks == 2 && kCGroups == kWSGroups,
              "the cluster path is two wide streamed blocks, each on its slice of D");
static_assert(cl_smem_floats(kCMaxD) * 4 <= kMaxSmem && cl_slice0(kCMaxD) == kCGroups * 64 &&
                  cl_slice0(kCMaxD + 1) > kCGroups * 64 && kCMaxD > kWSMaxD,
              "kCMaxD is the widest head whose slices fit the cluster path's register plan, "
              "and its tiles fit a block");

template <int D, int BQ>
int launch(const float* q, const float* k, const float* v, float* o, int BH,
           int Lq, int Lk, int causal, int blocks, int smem, float qscale,
           cudaStream_t stream) {
  if (static_cast<size_t>(smem) > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<D, BQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  flash_attention_kernel<D, BQ><<<blocks, 2 * BQ, smem, stream>>>(
      q, k, v, o, BH, Lq, Lk, (Lq + BQ - 1) / BQ, causal, qscale);
  return static_cast<int>(cudaGetLastError());
}

using LaunchFn = int (*)(const float*, const float*, const float*, float*, int,
                         int, int, int, int, int, float, cudaStream_t);

// The cluster path's launch: blocks of kWSThreads in clusters of kCBlocks
// along x (cudaLaunchKernelEx with the cluster-dimension attribute), or the
// configuration the occupancy query asks about; the kernel's shared memory
// opt-in first.
cudaError_t cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int blocks,
                           int smem, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(flash_attention_cluster_kernel<kCGroups>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCBlocks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(kWSThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

#define PIO_FLASH_ROW(d) {launch<d, 64>, launch<d, 128>}
// [D / 8 - 1][BQ == 128]
const LaunchFn kLaunch[kMaxD / 8][2] = {
    PIO_FLASH_ROW(8),  PIO_FLASH_ROW(16),  PIO_FLASH_ROW(24),  PIO_FLASH_ROW(32),
    PIO_FLASH_ROW(40), PIO_FLASH_ROW(48),  PIO_FLASH_ROW(56),  PIO_FLASH_ROW(64),
    PIO_FLASH_ROW(72), PIO_FLASH_ROW(80),  PIO_FLASH_ROW(88),  PIO_FLASH_ROW(96),
    PIO_FLASH_ROW(104), PIO_FLASH_ROW(112), PIO_FLASH_ROW(120), PIO_FLASH_ROW(128),
};
#undef PIO_FLASH_ROW

#define PIO_FLASH_ROW(d)                                          \
  reinterpret_cast<const void*>(flash_attention_kernel<d, 64>),  \
      reinterpret_cast<const void*>(flash_attention_kernel<d, 128>)
// in the order of kLaunch: D = 8, 16, ..., 128, each at BQ = 64 then 128
const void* const kKernels[2 * kMaxD / 8] = {
    PIO_FLASH_ROW(8),  PIO_FLASH_ROW(16),  PIO_FLASH_ROW(24),  PIO_FLASH_ROW(32),
    PIO_FLASH_ROW(40), PIO_FLASH_ROW(48),  PIO_FLASH_ROW(56),  PIO_FLASH_ROW(64),
    PIO_FLASH_ROW(72), PIO_FLASH_ROW(80),  PIO_FLASH_ROW(88),  PIO_FLASH_ROW(96),
    PIO_FLASH_ROW(104), PIO_FLASH_ROW(112), PIO_FLASH_ROW(120), PIO_FLASH_ROW(128),
};
#undef PIO_FLASH_ROW

}  // namespace

// Launches the forward on `stream` and returns cudaGetLastError() (0 = ok).
// Device pointers: q [BH, Lq, D], k and v [BH, Lk, D], o [BH, Lq, D] (output),
// all f32, contiguous and 16-byte aligned. D_true is the head width the
// caller's tensors had before the wrapper zero-padded them to D, the next
// multiple of 8 (D_true = D when they needed no padding): q is scaled by
// 1/sqrt(D_true), so a padded head answers as the unpadded one would and a
// width that needs no padding keeps the factor it always had. The plan
// (ops/cuda_kernels.py::
// flash_launch_plan): query rows a block bq (64 or 128), threads a block,
// dynamic shared memory in bytes, and blocks. A plan that does not match this
// arithmetic is refused (cudaErrorInvalidValue), as are BH, Lq, Lk < 1, a D
// that is not a multiple of 8 from 8 to 128, a D_true that does not round up
// to D, more than 65,535 query tiles,
// more than 2^31 - 1 blocks, and more shared memory than a block may have
// (bq = 128 at D = 128).
extern "C" int pio_flash_attention(const void* q, const void* k, const void* v,
                                   void* o, int BH, int Lq, int Lk, int D,
                                   int D_true, int causal, int bq, int threads,
                                   int smem, int blocks, void* stream) {
  if (BH < 1 || Lq < 1 || Lk < 1 || D < 8 || D > kMaxD || D % 8 != 0 ||
      D_true < D - 7 || D_true > D || (bq != kTile && bq != 2 * kTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long q_tiles = (Lq + bq - 1) / bq;
  const long long want_blocks = q_tiles * BH;
  if (q_tiles > kMaxQTiles || want_blocks > kMaxBlocks || blocks != want_blocks ||
      threads != 2 * bq || smem != smem_floats(bq, D) * static_cast<int>(sizeof(float)) ||
      smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return kLaunch[D / 8 - 1][bq == 2 * kTile](
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), BH, Lq, Lk,
      causal != 0, blocks, smem,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D_true))),
      static_cast<cudaStream_t>(stream));
}

// Launches the passes path on `stream` (it takes any D > kMaxD; the wrapper
// picks it above kCMaxD, and on request to compare it with the other paths)
// and returns cudaGetLastError() (0 = ok). Device pointers: q [BH, Lq, D], k and v
// [BH, Lk, D], o [BH, Lq, D], f32 and contiguous, unpadded; q is scaled by
// 1/sqrt(D). The plan (ops/cuda_kernels.py::flash_wide_launch_plan): threads
// a block (kWThreads) and blocks (ceil(Lq / kWRows) * BH * ceil(D / kWCols)).
// A plan that does not match this arithmetic is refused
// (cudaErrorInvalidValue), as are BH, Lq, Lk < 1, D <= kMaxD and more than
// 2^31 - 1 blocks.
extern "C" int pio_flash_attention_wide(const void* q, const void* k,
                                        const void* v, void* o, int BH, int Lq,
                                        int Lk, int D, int causal, int threads,
                                        int blocks, void* stream) {
  if (BH < 1 || Lq < 1 || Lk < 1 || D <= kMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long q_tiles = (Lq + kWRows - 1) / kWRows;
  const long long passes = (D + kWCols - 1) / kWCols;
  const long long want_blocks = q_tiles * BH * passes;
  if (want_blocks > kMaxBlocks || blocks != want_blocks || threads != kWThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const double width = D;  // unpadded: the true head width
  flash_attention_wide_kernel<<<blocks, kWThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), BH, Lq, Lk, D,
      static_cast<int>(q_tiles), static_cast<int>(passes), causal != 0,
      static_cast<float>(1.0 / std::sqrt(width)));
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread, local (spilled) bytes and static shared memory of the
// passes kernel, three ints. Returns the error of cudaFuncGetAttributes.
extern "C" int pio_flash_attention_wide_attrs(int* out) {
  cudaFuncAttributes at;
  const cudaError_t err = cudaFuncGetAttributes(
      &at, reinterpret_cast<const void*>(flash_attention_wide_kernel));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = at.numRegs;
  out[1] = static_cast<int>(at.localSizeBytes);
  out[2] = static_cast<int>(at.sharedSizeBytes);
  return 0;
}

// Launches the resident wide-head path (kMaxD < D <= kRMaxD) on `stream` and
// returns cudaGetLastError() (0 = ok). Device pointers: q [BH, Lq, D], k and v
// [BH, Lk, D], o [BH, Lq, D], f32 and contiguous, unpadded (16-byte copies
// when D is a multiple of 4 and all four are 16-byte aligned, else 4-byte
// ones); q is scaled by 1/sqrt(D). The plan (ops/cuda_kernels.py::
// flash_resident_launch_plan): threads a block (kRThreads), dynamic shared
// memory in bytes (res_smem_floats(D) floats) and blocks (ceil(Lq / kRRows) *
// BH). A plan that does not match this arithmetic is refused
// (cudaErrorInvalidValue), as are BH, Lq, Lk < 1, D outside (kMaxD, kRMaxD]
// and more than 2^31 - 1 blocks.
extern "C" int pio_flash_attention_resident(const void* q, const void* k,
                                            const void* v, void* o, int BH, int Lq,
                                            int Lk, int D, int causal, int threads,
                                            int smem, int blocks, void* stream) {
  if (BH < 1 || Lq < 1 || Lk < 1 || D <= kMaxD || D > kRMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long want_blocks = static_cast<long long>((Lq + kRRows - 1) / kRRows) * BH;
  if (want_blocks > kMaxBlocks || blocks != want_blocks || threads != kRThreads ||
      smem != res_smem_floats(D) * static_cast<int>(sizeof(float)) || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto aligned = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; };
  const int vec = D % 4 == 0 && aligned(q) && aligned(k) && aligned(v) && aligned(o);
  const double width = D;  // unpadded: the true head width
  return kResLaunch[res_groups(D) - kRGroupsMin](
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), BH, Lq, Lk, D, causal != 0,
      vec, blocks, smem, static_cast<float>(1.0 / std::sqrt(width)),
      static_cast<cudaStream_t>(stream));
}

// Registers a thread, local (spilled) bytes and static shared memory of the
// resident path's instantiations, three ints each, G = 3, 4, 5 in order.
// Returns the first error of cudaFuncGetAttributes.
extern "C" int pio_flash_attention_resident_attrs(int* out) {
  int i = 0;
  for (const void* kernel : kResKernels) {
    cudaFuncAttributes at;
    const cudaError_t err = cudaFuncGetAttributes(&at, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[i++] = at.numRegs;
    out[i++] = static_cast<int>(at.localSizeBytes);
    out[i++] = static_cast<int>(at.sharedSizeBytes);
  }
  return 0;
}

// Launches the streamed path (kMaxD < D <= kSMaxD; the wrapper picks it above
// kRMaxD, and on request to compare it with the resident path) on `stream`
// and returns cudaGetLastError() (0 = ok). Device pointers: q [BH, Lq, D], k
// and v [BH, Lk, D], o [BH, Lq, D], f32 and contiguous, unpadded (16-byte
// copies when D is a multiple of 4 and all four are 16-byte aligned, else
// 4-byte ones); q is scaled by 1/sqrt(D). The plan (ops/cuda_kernels.py::
// flash_streamed_launch_plan): threads a block (kSThreads), dynamic shared
// memory in bytes (str_smem_floats(D) floats) and blocks (ceil(Lq / kSRows) *
// BH). A plan that does not match this arithmetic is refused
// (cudaErrorInvalidValue), as are BH, Lq, Lk < 1, D outside (kMaxD, kSMaxD]
// and more than 2^31 - 1 blocks.
extern "C" int pio_flash_attention_streamed(const void* q, const void* k,
                                            const void* v, void* o, int BH, int Lq,
                                            int Lk, int D, int causal, int threads,
                                            int smem, int blocks, void* stream) {
  if (BH < 1 || Lq < 1 || Lk < 1 || D <= kMaxD || D > kSMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long want_blocks = static_cast<long long>((Lq + kSRows - 1) / kSRows) * BH;
  if (want_blocks > kMaxBlocks || blocks != want_blocks || threads != kSThreads ||
      smem != str_smem_floats(D) * static_cast<int>(sizeof(float)) || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_streamed_kernel<kSGroups>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; };
  const int vec = D % 4 == 0 && aligned(q) && aligned(k) && aligned(v) && aligned(o);
  const double width = D;  // unpadded: the true head width
  flash_attention_streamed_kernel<kSGroups>
      <<<blocks, kSThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(o), BH, Lq, Lk, D,
          (Lq + kSRows - 1) / kSRows, causal != 0, vec,
          static_cast<float>(1.0 / std::sqrt(width)));
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread, local (spilled) bytes and static shared memory of the
// streamed kernel, three ints. Returns the error of cudaFuncGetAttributes.
extern "C" int pio_flash_attention_streamed_attrs(int* out) {
  cudaFuncAttributes at;
  const cudaError_t err = cudaFuncGetAttributes(
      &at, reinterpret_cast<const void*>(flash_attention_streamed_kernel<kSGroups>));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = at.numRegs;
  out[1] = static_cast<int>(at.localSizeBytes);
  out[2] = static_cast<int>(at.sharedSizeBytes);
  return 0;
}

// Launches the wide streamed path (kMaxD < D <= kWSMaxD; the wrapper picks it
// above kSMaxD, and on request to compare it with the streamed path) on
// `stream` and returns cudaGetLastError() (0 = ok). Device pointers: q [BH,
// Lq, D], k and v [BH, Lk, D], o [BH, Lq, D], f32 and contiguous, unpadded
// (16-byte copies when D is a multiple of 4 and all four are 16-byte aligned,
// else 4-byte ones); q is scaled by 1/sqrt(D). The plan (ops/cuda_kernels.py::
// flash_wide_streamed_launch_plan): threads a block (kWSThreads), dynamic
// shared memory in bytes (ws_smem_floats(D) floats) and blocks (ceil(Lq /
// kWSRows) * BH). A plan that does not match this arithmetic is refused
// (cudaErrorInvalidValue), as are BH, Lq, Lk < 1, D outside (kMaxD, kWSMaxD]
// and more than 2^31 - 1 blocks.
extern "C" int pio_flash_attention_wide_streamed(const void* q, const void* k,
                                                 const void* v, void* o, int BH, int Lq,
                                                 int Lk, int D, int causal, int threads,
                                                 int smem, int blocks, void* stream) {
  if (BH < 1 || Lq < 1 || Lk < 1 || D <= kMaxD || D > kWSMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long want_blocks = static_cast<long long>((Lq + kWSRows - 1) / kWSRows) * BH;
  if (want_blocks > kMaxBlocks || blocks != want_blocks || threads != kWSThreads ||
      smem != ws_smem_floats(D) * static_cast<int>(sizeof(float)) || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wide_streamed_kernel<kWSGroups>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; };
  const int vec = D % 4 == 0 && aligned(q) && aligned(k) && aligned(v) && aligned(o);
  const double width = D;  // unpadded: the true head width
  flash_attention_wide_streamed_kernel<kWSGroups>
      <<<blocks, kWSThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(o), BH, Lq, Lk, D,
          (Lq + kWSRows - 1) / kWSRows, causal != 0, vec,
          static_cast<float>(1.0 / std::sqrt(width)));
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread, local (spilled) bytes and static shared memory of the
// wide streamed kernel, three ints. Returns the error of cudaFuncGetAttributes.
extern "C" int pio_flash_attention_wide_streamed_attrs(int* out) {
  cudaFuncAttributes at;
  const cudaError_t err = cudaFuncGetAttributes(
      &at, reinterpret_cast<const void*>(flash_attention_wide_streamed_kernel<kWSGroups>));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = at.numRegs;
  out[1] = static_cast<int>(at.localSizeBytes);
  out[2] = static_cast<int>(at.sharedSizeBytes);
  return 0;
}

// Launches the cluster path (kMaxD < D <= kCMaxD; the wrapper picks it above
// kWSMaxD, and on request to compare it with the wide streamed path) on
// `stream` and returns the launch's error (0 = ok). Device pointers: q [BH,
// Lq, D], k and v [BH, Lk, D], o [BH, Lq, D], f32 and contiguous, unpadded
// (16-byte copies when D is a multiple of 4 and all four are 16-byte
// aligned, else 4-byte ones); q is scaled by 1/sqrt(D). The plan
// (ops/cuda_kernels.py::flash_cluster_launch_plan): threads a block
// (kWSThreads), blocks a cluster (kCBlocks), the two slices' widths
// (cl_slice_width), dynamic shared memory in bytes (cl_smem_floats(D)
// floats) and blocks (ceil(Lq / kWSRows) * BH * kCBlocks). A plan that does
// not match this arithmetic is refused (cudaErrorInvalidValue), as are BH,
// Lq, Lk < 1, D outside (kMaxD, kCMaxD] and more than 2^31 - 1 blocks.
extern "C" int pio_flash_attention_cluster(const void* q, const void* k, const void* v,
                                           void* o, int BH, int Lq, int Lk, int D, int causal,
                                           int threads, int cluster, int slice0, int slice1,
                                           int smem, int blocks, void* stream) {
  if (BH < 1 || Lq < 1 || Lk < 1 || D <= kMaxD || D > kCMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long q_tiles = (Lq + kWSRows - 1) / kWSRows;
  const long long want_blocks = q_tiles * BH * kCBlocks;
  if (want_blocks > kMaxBlocks || blocks != want_blocks || threads != kWSThreads ||
      cluster != kCBlocks || slice0 != cl_slice_width(D, 0) || slice1 != cl_slice_width(D, 1) ||
      smem != cl_smem_floats(D) * static_cast<int>(sizeof(float)) || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(&cfg, &attr, blocks, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; };
  const int vec = D % 4 == 0 && aligned(q) && aligned(k) && aligned(v) && aligned(o);
  const double width = D;  // unpadded: the true head width
  err = cudaLaunchKernelEx(&cfg, flash_attention_cluster_kernel<kCGroups>,
                           static_cast<const float*>(q), static_cast<const float*>(k),
                           static_cast<const float*>(v), static_cast<float*>(o), BH, Lq, Lk, D,
                           static_cast<int>(q_tiles), causal != 0 ? 1 : 0, vec,
                           static_cast<float>(1.0 / std::sqrt(width)));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of the cluster path with `smem` bytes of dynamic shared memory a
// block that the card holds at once (cudaOccupancyMaxActiveClusters), into
// *out. Returns the first error.
extern "C" int pio_flash_attention_cluster_occupancy(int smem, int* out) {
  if (smem < 0 || smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t err = cluster_config(&cfg, &attr, kCBlocks, smem, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out, flash_attention_cluster_kernel<kCGroups>, &cfg));
}

// Registers a thread, local (spilled) bytes and static shared memory of the
// cluster kernel, three ints. Returns the error of cudaFuncGetAttributes.
extern "C" int pio_flash_attention_cluster_attrs(int* out) {
  cudaFuncAttributes at;
  const cudaError_t err = cudaFuncGetAttributes(
      &at, reinterpret_cast<const void*>(flash_attention_cluster_kernel<kCGroups>));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = at.numRegs;
  out[1] = static_cast<int>(at.localSizeBytes);
  out[2] = static_cast<int>(at.sharedSizeBytes);
  return 0;
}

// Registers a thread, local (spilled) bytes and static shared memory of every
// instantiation, three ints each, in this order: D = 8, 16, ..., 128, each at
// bq = 64 then 128. Returns the first error of cudaFuncGetAttributes.
extern "C" int pio_flash_attention_attrs(int* out) {
  int i = 0;
  for (const void* kernel : kKernels) {
    cudaFuncAttributes at;
    const cudaError_t err = cudaFuncGetAttributes(&at, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[i++] = at.numRegs;
    out[i++] = static_cast<int>(at.localSizeBytes);
    out[i++] = static_cast<int>(at.sharedSizeBytes);
  }
  return 0;
}

extern "C" const char* pio_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
