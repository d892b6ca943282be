// Streaming top-k for recommendation serving, hand-written for Hopper (sm_90a).
//
// Replaces predictionio_tpu/ops/pallas_kernels.py::_topk_kernel (the Pallas
// body of top_k_streaming, with its selection helper _select_topk). For each
// query row b it returns the k best (score, item) pairs of q[b] . items[n]
// over the whole catalog, ordered by score descending and, on equal scores,
// by item index ascending. Up to k = 256 the [B, N] score matrix never
// reaches device memory: scores live in registers and shared memory only.
// Above it the select path stores each score once (4 bytes) and reads it
// back once, which costs less than sorting and merging every key.
//
// Contract (the JAX kernel's, checked by tests/test_torch_topk.py against it
// and by chip_smoke.py against the plain PyTorch version on the card):
//   - excl is [B, E] item ids, -1 padded; an excluded item scores -inf;
//   - any slot whose score is -inf carries index -1;
//   - the caller clamps k to N and pads back to the requested k;
//   - any rank R (no padding of R), any N (the ragged last tile is masked);
//   - each score is one chain of fp32 FMAs over ranks 0..R-1 (no tensor
//     cores, no library product).
//
// Keys stay distinct until the last write. A candidate is the pair (score,
// item index); a masked slot (excluded, or past N in the ragged tile) scores
// -inf but keeps its own index, and only the padding of an empty running
// list takes the sentinel indices above kSentinelBase. So within one query
// no two keys ever compare equal, the rank of a key in a union of sorted
// lists is its position plus one binary search per other list, the ranks are
// a permutation, and every merge below is exact. Only the final store turns
// -inf into index -1.
//
// Design. The TPU kernel walks item tiles in grid order and carries a running
// [B, k] top-k in VMEM from one grid step to the next. Blocks on the card run
// in no order, so the running list lives where an order exists: inside a
// block, as a loop over a run of T consecutive 256-item tiles. The host's
// launch plan (ops/cuda_kernels.py::topk_launch_plan) picks T so that the
// blocks fill the card in one wave: at B = 1 every tile is a block, at
// B = 1024 a block walks 27 tiles and a query leaves 4 lists, not 106.
//   Stage 1, k <= 128 (topk_run_kernel): one block per (8-query tile x run).
//     The q rows are staged in shared memory once, rank-major, so that a
//     thread reads the eight q values of a rank as two 16-byte broadcasts.
//     The item tile comes 16 ranks at a time, through registers: the loads of
//     the next chunk are started before the FMAs of this one. Each thread owns
//     one item of the tile and accumulates 8 dot products. Per query the
//     block keeps a sorted running top-kt list, started at (-inf, sentinels)
//     as the TPU kernel starts its output block. After masking, a candidate
//     is tested against the list's last key (the threshold): only those that
//     rank before it survive and are gathered (ballot + one shared counter
//     per query). Then warp w merges query w:
//       - sparse tile (at most 32 survivors in every query): each survivor
//         ranks itself among the survivors by counting and in the list by
//         binary search; each list element counts the survivors before it;
//       - dense tile (the first of a run, or a catalog whose scores rise with
//         the index): every warp sorts its 32 candidates in registers
//         (shuffle bitonic network), the eight sorted heads merge pairwise in
//         three rounds, and the result merges with the running list by rank.
//     In random order tile t of a run expects about kt/(t-1) survivors per
//     query, so a run of T tiles sorts one tile and filters the rest.
//   Stage 1, 128 < k <= 256 (topk_run_tiled_kernel): the same running list,
//     up to kt = 256 (kRunMaxKt), with a register-tiled scoring core and a
//     lazy merge. A block scores a step of 4 tiles (1,024 items) at a time:
//     each thread owns 4 consecutive items x 8 queries (32 accumulators),
//     reads its 4 item values of a rank as one 16-byte load and the 8 q values
//     as two broadcasts, so 32 FMAs take 3 shared loads (8 per 3 in
//     topk_run_kernel). The step's ranks come 8 at a time (a [8][1028] chunk,
//     32 values a thread in flight; a step's first chunk comes by cp.async
//     while the step before is selected). The step's 1,024 candidates are
//     then selected as 4 slices of 256 (slice c: items 4t + c), in order, into
//     one list of kt keys a query for the whole run (select_slice). Rewriting
//     a list of 256 for every sparse slice is what bound this path when it
//     ran topk_run_kernel's merge (knock-outs in PERF.md), so a sparse
//     slice's survivors wait in a pending buffer of 128 a query, and the
//     lists are rewritten only once some query holds more than 64 of them, or
//     at the end of the run (merge_pending: the pending keys sorted in
//     registers, every key placed by binary search). The threshold stays the
//     list's last key, so no pending key is lost. A slice that only gathers
//     takes one barrier. A slice is dense only above 64 survivors in some
//     query: then warp w sorts query w's 256 candidates in registers (a
//     bitonic network, eight a lane) and merges them with the list by rank;
//     the run's first slice becomes the list directly. A run is a whole
//     number of steps (T a multiple of 4) or the whole catalog. Either
//     running-list kernel can be launched at any k <= 256 (the plan picks
//     topk_run_kernel up to 128 and this one above).
//   256 < k <= kSelectMaxKeys = 16,384: the threshold select (pio_topk_select).
//     Sorting every tile and merging every list moves all N keys of a query
//     through shared memory, device memory and ceil(log2 n_tiles) rounds of
//     binary searches, when the answer needs only k of them. Instead:
//     (1) topk_select_score_kernel scores as topk_run_tiled_kernel does, masks,
//     canonicalises (-0.0 -> +0.0) and stores each score to a [B, N] scratch
//     (4 bytes a key, half the per-tile path's lists) and counts its
//     order-preserving 32-bit key in a per-query histogram of the top 11 bits,
//     in shared memory, added to device memory with integer atomics (exact in
//     any order). (2) topk_select_kernel, one block of 1,024 threads a query,
//     finds the bin that holds the k-th key (a block scan of the histogram from
//     the top); when that bin's keys and those above it do not fit the
//     survivor buffer it counts that bin's keys again on the next 11 bits, and
//     then on the last 10 (the boundary is then the k-th key itself). It
//     gathers every key from the boundary up as a packed 8-byte key (~score
//     bits, index: one ascending order for score desc, index asc), in any
//     order; at an exact key the ties are taken in index order by a block scan
//     until k are held. The survivors (k plus about one bin) are sorted in
//     shared memory by a bitonic network whose strides below 256 run in
//     registers, 8 keys a lane, and the first k are stored. Above the ceiling
//     (whose packed keys no longer fit a block's shared memory) the per-tile
//     sort below stays: at k = N = 27,000 it beats torch.topk.
//   Stage 1, k > 16,384 (topk_tile_kernel): one block per (8-query tile x
//     item tile), T = 1: a bitonic sort of the 256 candidates in shared
//     memory, the best kt = 256 kept. It also answers any smaller kt when the
//     plan asks (the card's checks force it beside every other path).
//   Stage 2: a query's n_runs sorted lists merge as a tree: all pairs of a
//     round at once, each key placed at its position plus its rank in the
//     sibling list and dropped past k, in ceil(log2(n_runs)) rounds. A node's
//     list is written where its first leaf was, so storage never grows; an
//     odd list out is copied through. When two copies of a query's lists fit
//     in shared memory (227 KB) one block per query runs all rounds there with
//     a barrier between them (topk_merge_kernel); else every round is a launch
//     over all queries' keys between the scratch and a second scratch
//     (topk_merge_round_kernel, then topk_store_kernel), so that a few long
//     queries still fill the card.
//   Query slots past B in the last query tile are neither sorted nor stored.
//
// Ceiling: k <= kMaxK = 2^29, the catalog's own ceiling, so any k clamped to N
// is taken. The sentinel indices start at INT_MAX - kMaxK, above every real
// index (N <= 2^29); within one query the merge indexes keys with ints, and a
// query's lists hold at most span = n_runs * kt <= 2^29 keys (a round's key
// count stays below 2^30); every offset across queries is size_t. The store
// strides over at most 65,535 blocks a query, so K is not bound by the grid.
// The select path keeps 4 N bytes and 8 KB of counts a query, the per-tile
// sort every tile's list, about 8 N bytes a query: the wrapper cuts the batch
// so that one launch's scratch stays within a fixed budget
// (ops/cuda_kernels.py::topk_batch_slices).
//
// Bound at the serving slice's shapes (ML-20M width: N = 27,000 items, R = 50,
// k = 16; H100 SXM data sheet: 3.35 TB/s, fp32 outside the tensor cores about
// 67 TFLOP/s): one batch reads the 5.4 MB item table once (about 1.6 us);
// B = 64 is 0.17 GFLOP (about 2.6 us), B = 1024 is 2.8 GFLOP (about 41 us), so
// large batches are bound by fp32 FMAs. What holds topk_run_kernel above that
// bound is the shared-memory path, not the FMAs: a thread computes 1 item x 8
// queries, three shared-memory loads for every 8 FMAs, and stages every item
// value with a load and a store of its own. Each block of 8 queries reads the
// whole table from L2 once a run, 4 bytes for 16 FLOP: at large batches that
// traffic and the selection, not the FMAs, bound topk_run_tiled_kernel
// (knock-outs and measured times in PERF.md). More queries a block, copies of
// every chunk by cp.async and a tensor-core product on an exact fp32 split are
// later work.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTileItems = 256;    // items per stage-1 tile, one per thread
constexpr int kTileQueries = 8;    // queries per stage-1 block
constexpr int kRankChunk = 16;     // ranks staged in shared memory per step
constexpr int kItemStride = kTileItems + 1;  // staged chunk row, bank-skewed
constexpr int kMaxK = 536870912;  // 2^29
constexpr int kRunMaxKt = 256;     // the running-list kernels take kt up to this
constexpr int kSparseMax = 32;     // survivors per query a sparse merge takes
constexpr int kMergeThreads = 256;        // per block of a merge round
constexpr int kMergeThreadsLarge = 1024;  // the most the one-block merge takes
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may opt into
constexpr int kOptInFrom = 48 * 1024;
constexpr int kMaxDevices = 64;
// Running-list padding takes indices above every real item index.
constexpr int kSentinelBase = INT_MAX - kMaxK;
constexpr unsigned kFullWarp = 0xffffffffu;

static_assert(kTileItems / 32 == kTileQueries,
              "stage 1 merges one query per warp");
static_assert(kRankChunk == 16, "load_chunk splits a thread index by 16");

// topk_run_tiled_kernel: a step of kStepTiles tiles, 4 items a thread, its
// ranks staged kTiledChunk at a time in rows of kStepStride floats (the
// 4-float skew puts the 8 ranks x 4 items of a warp's store in 32 banks).
constexpr int kStepTiles = 4;
constexpr int kStepItems = kStepTiles * kTileItems;
constexpr int kTiledChunk = 8;
constexpr int kStepStride = kStepItems + 4;
constexpr int kTiledLoads = kStepItems * kTiledChunk / kTileItems;  // a thread's
constexpr int kTiledBlocksPerSm = 2;  // its launch bound: up to 128 registers
constexpr int kExWordsTiled = kStepItems / 32;  // exclusion words a query a step
// A slice of the tiled kernel is dense above kTiledSparseMax survivors in some
// query; up to 2 x that many keys a query wait in its pending buffer.
constexpr int kTiledSparseMax = 64;
constexpr int kPendMax = 2 * kTiledSparseMax;
static_assert(kStepTiles == 4 && kTiledChunk == 8,
              "load_step_chunk splits a thread index by 8, 4 items a thread");

// The select path (k > 256): a query's order keys are counted by their top
// kSelectBins (11 bits), then in the boundary bin by the next 11 and the last
// kSelectLastBins (10 bits). A select block of kSelectThreads holds up to
// kSelectMaxKeys survivors as packed 8-byte keys and sorts them in place;
// kSelectMisc ints of shared memory hold its scan and counters.
constexpr int kSelectBins = 2048;
constexpr int kSelectLastBins = 1024;
constexpr int kSelectThreads = 1024;
constexpr int kSelectMaxKeys = 16384;
constexpr int kSelectMisc = 64;
constexpr int kSortSegment = 256;  // keys a warp sorts in registers, 8 a lane
constexpr int kSortMin = 512;      // the shortest sort: two segments
// topk_select_score_kernel's launch bound (up to 128 registers a thread): its
// histogram holds it to two blocks an SM by shared memory in any case
constexpr int kSelectScoreBlocksPerSm = 2;

// Shared memory of topk_select_score_kernel and topk_select_kernel, in bytes
// (the launch plan computes the same numbers).
__host__ __device__ constexpr int select_score_smem_bytes(int R) {
  return 4 * (kTileQueries * R + kTiledChunk * kStepStride +
              kTileQueries * kSelectBins + kTileQueries * kExWordsTiled);
}
__host__ __device__ constexpr int select_smem_bytes(int survivors) {
  return 8 * survivors + 4 * (kSelectBins + kSelectMisc);
}
static_assert(select_smem_bytes(kSelectMaxKeys) <= kMaxSmem &&
                  select_smem_bytes(2 * kSelectMaxKeys) > kMaxSmem,
              "kSelectMaxKeys: the longest power of two whose keys fit");
static_assert(kSelectBins % kSelectThreads == 0 &&
                  kSelectLastBins % kSelectThreads == 0,
              "find_boundary gives each thread whole bins");

// True when (sa, ia) ranks ahead of (sb, ib): higher score, then lower index.
__device__ __forceinline__ bool before(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// How many keys of the sorted list (ls, li)[0..len) rank before (s, i).
__device__ __forceinline__ int count_before(const float* ls, const int* li,
                                            int len, float s, int i) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (before(ls[mid], li[mid], s, i)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// A rank chunk goes from device memory to shared memory through registers,
// so that the loads of the next chunk are in flight while this one is scored.
// A full chunk is the tile's [256 items][16 ranks] block. Each half-warp
// moves one item's 16 ranks (a 64-byte piece of its row) at a time: thread t
// takes rank t % 16 of items chunk_item(t, m), m = 0..15. The two halves of a
// warp take items 16 apart, so that their stores to s_items[rank][item] (row
// stride 257) fall in different banks. Rows past N read as 0. A chunk of
// fewer ranks (R < 16) splits element l = t + 256 m into item l / rc, rank
// l % rc.
__device__ __forceinline__ int chunk_item(int t, int m) {
  return 32 * (t >> 5) + 16 * ((t >> 4) & 1) + m;
}

__device__ __forceinline__ void load_chunk(float (&pre)[kRankChunk],
                                           const float* __restrict__ items,
                                           int item0, int N, int R, int r0,
                                           int rc, int t) {
  if (rc == kRankChunk) {
    const int rr = t & (kRankChunk - 1);
#pragma unroll
    for (int m = 0; m < kRankChunk; ++m) {
      const int gi = item0 + chunk_item(t, m);
      pre[m] = gi < N ? items[(size_t)gi * R + r0 + rr] : 0.f;
    }
  } else {
#pragma unroll
    for (int m = 0; m < kRankChunk; ++m) {
      if (m < rc) {
        const int l = t + m * kTileItems;
        const int it = l / rc;
        const int gi = item0 + it;
        pre[m] = gi < N ? items[(size_t)gi * R + r0 + (l - it * rc)] : 0.f;
      }
    }
  }
}

// Writes the chunk to s_items[rank][item] (row stride kItemStride).
__device__ __forceinline__ void store_chunk(float* s_items,
                                            const float (&pre)[kRankChunk],
                                            int rc, int t) {
  if (rc == kRankChunk) {
    const int rr = t & (kRankChunk - 1);
#pragma unroll
    for (int m = 0; m < kRankChunk; ++m) {
      s_items[rr * kItemStride + chunk_item(t, m)] = pre[m];
    }
  } else {
#pragma unroll
    for (int m = 0; m < kRankChunk; ++m) {
      if (m < rc) {
        const int l = t + m * kTileItems;
        const int it = l / rc;
        s_items[(l - it * rc) * kItemStride + it] = pre[m];
      }
    }
  }
}

// Adds ranks [first, rc) of the staged chunk (which starts at rank r0) of the
// calling thread's item to its dot products with the block's queries. q_t is
// [R][8] (rank-major), so the eight q values of a rank are two 16-byte
// broadcasts; with at most four live queries the second is skipped.
__device__ __forceinline__ void score_chunk(float (&acc)[kTileQueries],
                                            const float* s_items,
                                            const float* q_t, int r0, int first,
                                            int rc, int nq, int t) {
  const float* qrow = q_t + (size_t)r0 * kTileQueries;
  if (first == 0 && rc == kRankChunk) {
#pragma unroll
    for (int rr = 0; rr < kRankChunk; ++rr) {
      const float x = s_items[rr * kItemStride + t];
      const float4 a = *reinterpret_cast<const float4*>(qrow + rr * 8);
      acc[0] = fmaf(a.x, x, acc[0]);
      acc[1] = fmaf(a.y, x, acc[1]);
      acc[2] = fmaf(a.z, x, acc[2]);
      acc[3] = fmaf(a.w, x, acc[3]);
      if (nq > 4) {
        const float4 b = *reinterpret_cast<const float4*>(qrow + rr * 8 + 4);
        acc[4] = fmaf(b.x, x, acc[4]);
        acc[5] = fmaf(b.y, x, acc[5]);
        acc[6] = fmaf(b.z, x, acc[6]);
        acc[7] = fmaf(b.w, x, acc[7]);
      }
    }
  } else {
    for (int rr = first; rr < rc; ++rr) {
      const float x = s_items[rr * kItemStride + t];
      const float4 a = *reinterpret_cast<const float4*>(qrow + rr * 8);
      const float4 b = *reinterpret_cast<const float4*>(qrow + rr * 8 + 4);
      acc[0] = fmaf(a.x, x, acc[0]);
      acc[1] = fmaf(a.y, x, acc[1]);
      acc[2] = fmaf(a.z, x, acc[2]);
      acc[3] = fmaf(a.w, x, acc[3]);
      acc[4] = fmaf(b.x, x, acc[4]);
      acc[5] = fmaf(b.y, x, acc[5]);
      acc[6] = fmaf(b.z, x, acc[6]);
      acc[7] = fmaf(b.w, x, acc[7]);
    }
  }
}

// The ranks are walked in chunks of C (16, or 8 in the tiled kernel). When
// R >= C is no multiple of C the last chunk is staged from rank R - C, full
// width like the others (it reads again some ranks of the chunk before it),
// and scored from its first new rank; so every staged chunk takes the fast
// split, and each score still sums ranks 0..R-1 in order. chunk_start is where
// the chunk that covers the ranks from r0 is staged from, chunk_width how many
// ranks it holds.
template <int C>
__device__ __forceinline__ int chunk_start(int R, int r0) {
  return (R >= C && R - r0 < C) ? R - C : r0;
}

template <int C>
__device__ __forceinline__ int chunk_width(int R) { return min(C, R); }

// The tiled kernel's rank chunk: [1024 items][8 ranks] of the step, through
// registers like load_chunk's. Thread t takes rank t % 8 of items t / 8 + 32 m,
// m = 0..31: eight lanes read one item's 32-byte piece of its row, a warp four
// items. Rows past N read as 0. A chunk of fewer ranks (R < 8) splits element
// l = t + 256 m (m < 4 rc) into item l / rc, rank l % rc.
__device__ __forceinline__ void load_step_chunk(float (&pre)[kTiledLoads],
                                                const float* __restrict__ items,
                                                int step0, int N, int R, int r0,
                                                int rc, int t) {
  if (rc == kTiledChunk) {
    const int rr = t & (kTiledChunk - 1);
#pragma unroll
    for (int m = 0; m < kTiledLoads; ++m) {
      const int gi = step0 + (t >> 3) + 32 * m;
      pre[m] = gi < N ? items[(size_t)gi * R + r0 + rr] : 0.f;
    }
  } else {
#pragma unroll
    for (int m = 0; m < kTiledLoads; ++m) {
      if (m < 4 * rc) {
        const int l = t + m * kTileItems;
        const int it = l / rc;
        const int gi = step0 + it;
        pre[m] = gi < N ? items[(size_t)gi * R + r0 + (l - it * rc)] : 0.f;
      }
    }
  }
}

// Writes the step's chunk to s_items[rank][item] (row stride kStepStride).
__device__ __forceinline__ void store_step_chunk(float* s_items,
                                                 const float (&pre)[kTiledLoads],
                                                 int rc, int t) {
  if (rc == kTiledChunk) {
    const int rr = t & (kTiledChunk - 1);
#pragma unroll
    for (int m = 0; m < kTiledLoads; ++m) {
      s_items[rr * kStepStride + (t >> 3) + 32 * m] = pre[m];
    }
  } else {
#pragma unroll
    for (int m = 0; m < kTiledLoads; ++m) {
      if (m < 4 * rc) {
        const int l = t + m * kTileItems;
        const int it = l / rc;
        s_items[(l - it * rc) * kStepStride + it] = pre[m];
      }
    }
  }
}

// The step's first rank chunk (ranks 0..rc-1) straight to shared memory with
// cp.async, in store_step_chunk's places, 4 bytes an element (rows past N are
// zero-filled). It is issued after the previous step's last chunk was read and
// lands while that step's slices are selected, so no register holds it then.
__device__ __forceinline__ void copy_first_chunk_async(float* s_items,
                                                       const float* items,
                                                       int step0, int N, int R,
                                                       int rc, int t) {
#pragma unroll
  for (int m = 0; m < kTiledLoads; ++m) {
    int it = (t >> 3) + 32 * m;
    int rr = t & (kTiledChunk - 1);
    if (rc != kTiledChunk) {
      if (m >= 4 * rc) break;
      const int l = t + m * kTileItems;
      it = l / rc;
      rr = l - it * rc;
    }
    const int gi = step0 + it;
    const float* src = items + (gi < N ? (size_t)gi * R + rr : 0);
    const unsigned dst = static_cast<unsigned>(
        __cvta_generic_to_shared(s_items + rr * kStepStride + it));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(gi < N ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Adds ranks [first, rc) of the staged step chunk (which starts at rank r0) to
// the calling thread's 4 x 8 dot products: items 4t..4t+3 (one 16-byte load a
// rank) with the block's 8 queries (two 16-byte broadcasts).
__device__ __forceinline__ void score_step_chunk(
    float (&acc)[kStepTiles][kTileQueries], const float* s_items,
    const float* q_t, int r0, int first, int rc, int t) {
  const float* qrow = q_t + (size_t)r0 * kTileQueries;
#pragma unroll
  for (int rr = 0; rr < kTiledChunk; ++rr) {
    if (rr >= first && rr < rc) {
      const float4 x =
          *reinterpret_cast<const float4*>(s_items + rr * kStepStride + 4 * t);
      const float4 a = *reinterpret_cast<const float4*>(qrow + rr * 8);
      const float4 b = *reinterpret_cast<const float4*>(qrow + rr * 8 + 4);
      const float xs[kStepTiles] = {x.x, x.y, x.z, x.w};
      const float qs[kTileQueries] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int c = 0; c < kStepTiles; ++c) {
#pragma unroll
        for (int qi = 0; qi < kTileQueries; ++qi) {
          acc[c][qi] = fmaf(qs[qi], xs[c], acc[c][qi]);
        }
      }
    }
  }
}

// One key of one round of the pairwise tree merge. Sorted lists of `leaf` keys
// lie side by side, list l at l * stride. In the round of `width`, node c
// covers the leaves from c * width and holds min(K, leaves * leaf) keys at the
// offset of its first leaf; w = c * cap + pos names key pos of node c (cap =
// min(K, width * leaf), the most a node holds). The key goes to its position
// plus its rank in the sibling node, dropped past K; a node without a sibling
// is copied through. Each parent slot below K is written exactly once.
__device__ __forceinline__ void merge_round_key(const float* src_s,
                                                const int* src_i, float* dst_s,
                                                int* dst_i, int w, int n_lists,
                                                int leaf, int stride, int K,
                                                int width, int cap) {
  const int c = w / cap;
  const int pos = w - c * cap;
  const int len = min(K, min(width, n_lists - c * width) * leaf);
  if (pos >= len) return;
  const int off = c * width * stride;
  const float s = src_s[off + pos];
  const int i = src_i[off + pos];
  const int sib = c ^ 1;
  if (sib * width < n_lists) {
    const int sib_len = min(K, min(width, n_lists - sib * width) * leaf);
    const int sib_off = sib * width * stride;
    const int rank =
        pos + count_before(src_s + sib_off, src_i + sib_off, sib_len, s, i);
    if (rank < K) {
      const int o = (c >> 1) * 2 * width * stride + rank;
      dst_s[o] = s;
      dst_i[o] = i;
    }
  } else {
    dst_s[off + pos] = s;
    dst_i[off + pos] = i;
  }
}

// The tiled kernel's selection. Warp w merges query w, as in topk_run_kernel,
// but a sparse slice does not rewrite the list: its survivors wait in a
// pending buffer (kPendMax a query) and the list is rewritten only when some
// query holds more than kTiledSparseMax of them, or at the end of the run.
// The threshold stays the list's last key, so a pending key is never lost:
// the best kt of all keys seen are always among the list and the pending
// keys. A slice is dense, and sorts all its candidates, only when some query
// has more than kTiledSparseMax survivors: in random order the first few
// slices of a run.

// Sorts the 32 H keys held H a lane (key e = lane + 32 h in (s[h], i[h]))
// best first with a bitonic network: strides below 32 by shuffles, the others
// between a lane's own keys.
template <int H>
__device__ __forceinline__ void warp_sort(float (&s)[H], int (&i)[H], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * H; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const int g = h ^ (stride >> 5);
          if (g > h) {  // the pair (h, g) of this lane, h the lower key
            const bool best_first = ((32 * h) & size) == 0;
            if (best_first == before(s[g], i[g], s[h], i[h])) {
              const float fs = s[h]; s[h] = s[g]; s[g] = fs;
              const int fi = i[h]; i[h] = i[g]; i[g] = fi;
            }
          }
        }
      } else {
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const float os = __shfl_xor_sync(kFullWarp, s[h], stride);
          const int oi = __shfl_xor_sync(kFullWarp, i[h], stride);
          const bool lower = (lane & stride) == 0;
          const bool best_first = ((lane + 32 * h) & size) == 0;
          // the lower key of a best-first pair keeps the better one
          if ((lower == best_first) == before(os, oi, s[h], i[h])) {
            s[h] = os;
            i[h] = oi;
          }
        }
      }
    }
  }
}

// Places key m of the sorted list (as, ai) of length kt, m = lane + 32 u for
// u in [u0, u0 + 4), at m plus its rank in the sorted list (bs, bi) of len
// keys, into (ns, ni) if below kt. The four ranks are computed before any
// store, so that their searches overlap.
__device__ __forceinline__ void place_four(const float* as, const int* ai,
                                           const float* bs, const int* bi,
                                           int len, float* ns, int* ni, int kt,
                                           int u0, int lane) {
  float ks[4];
  int ki[4], kr[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int m = lane + 32 * (u0 + u);
    kr[u] = kt;
    if (m < kt) {
      ks[u] = as[m];
      ki[u] = ai[m];
      kr[u] = m + count_before(bs, bi, len, ks[u], ki[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (kr[u] < kt) {
      ns[kr[u]] = ks[u];
      ni[kr[u]] = ki[u];
    }
  }
}

// Merges the n (<= kPendMax) unsorted pending keys (ps, pi) of one query into
// its list (ls, li) -> (ns, ni): the 128 slots sorted in registers (slots past
// n as (-inf, INT_MAX), after every key), the sorted keys written to (ss, si)
// for the list's binary searches, each key placed at its rank in the union
// and dropped past kt. One warp.
__device__ __forceinline__ void merge_pending(const float* ps, const int* pi,
                                              int n, const float* ls,
                                              const int* li, float* ns, int* ni,
                                              float* ss, int* si, int kt,
                                              int lane) {
  constexpr int H = kPendMax / 32;
  float s[H];
  int i[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int e = lane + 32 * h;
    s[h] = e < n ? ps[e] : -CUDART_INF_F;
    i[h] = e < n ? pi[e] : INT_MAX;
  }
  warp_sort<H>(s, i, lane);
  int r[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    ss[lane + 32 * h] = s[h];
    si[lane + 32 * h] = i[h];
    r[h] = lane + 32 * h < n ? lane + 32 * h + count_before(ls, li, kt, s[h], i[h])
                             : kt;
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
    if (r[h] < kt) {
      ns[r[h]] = s[h];
      ni[r[h]] = i[h];
    }
  }
  __syncwarp();
  place_four(ls, li, ss, si, n, ns, ni, kt, 0, lane);
  place_four(ls, li, ss, si, n, ns, ni, kt, 4, lane);
}

// The dense slice: every thread writes its candidate of each query to s_cs;
// after a barrier warp w sorts query w's 256 candidates in registers (eight
// a lane, warp_sort) and merges the best kt with the list, or, on the run's
// first slice (`fresh`: the list holds only sentinels, which rank after
// every key), takes them as the list. A slice key beyond the best kt cannot
// enter the list, so the list's keys are ranked among the best kt only.
__device__ __forceinline__ void dense_slice(const float (&acc)[kTileQueries],
                                            int j, int nq, int kt, bool fresh,
                                            float* s_cs, int* s_ci,
                                            const float* cur_s, const int* cur_i,
                                            float* nxt_s, int* nxt_i, int t) {
  const int lane = t & 31;
  const int warp = t >> 5;
#pragma unroll
  for (int qi = 0; qi < kTileQueries; ++qi) {
    if (qi < nq) {
      s_cs[qi * kTileItems + t] = acc[qi];
      s_ci[qi * kTileItems + t] = j;
    }
  }
  __syncthreads();
  if (warp >= nq) return;
  constexpr int H = kTileItems / 32;
  float* cs = s_cs + warp * kTileItems;
  int* ci = s_ci + warp * kTileItems;
  float s[H];
  int i[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    s[h] = cs[lane + 32 * h];
    i[h] = ci[lane + 32 * h];
  }
  warp_sort<H>(s, i, lane);
  float* ns = nxt_s + warp * kt;
  int* ni = nxt_i + warp * kt;
  if (fresh) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      if (lane + 32 * h < kt) {
        ns[lane + 32 * h] = s[h];
        ni[lane + 32 * h] = i[h];
      }
    }
    return;
  }
  // the sorted slice goes back to its query's row (every lane has read it)
  __syncwarp();
#pragma unroll
  for (int h = 0; h < H; ++h) {
    cs[lane + 32 * h] = s[h];
    ci[lane + 32 * h] = i[h];
  }
  __syncwarp();
  const float* ls = cur_s + warp * kt;
  const int* li = cur_i + warp * kt;
  place_four(cs, ci, ls, li, kt, ns, ni, kt, 0, lane);
  place_four(cs, ci, ls, li, kt, ns, ni, kt, 4, lane);
  place_four(ls, li, cs, ci, kt, ns, ni, kt, 0, lane);
  place_four(ls, li, cs, ci, kt, ns, ni, kt, 4, lane);
}

// A query's pending count, 8 bits of pend[qi / 4] (at most kPendMax).
__device__ __forceinline__ int pending(const unsigned (&pend)[2], int qi) {
  return static_cast<int>(((qi >> 2) ? pend[1] : pend[0]) >> (8 * (qi & 3))) & 0xff;
}

// Warp w merges query w's pending keys into its list (buffer cur into
// cur ^ 1; the caller flips cur), then a barrier; every count returns to 0.
__device__ __forceinline__ void flush_pending(
    int nq, int kt, float* s_cs, int* s_ci, const float* cur_s,
    const int* cur_i, float* nxt_s, int* nxt_i, const float* s_ps,
    const int* s_pi, unsigned (&pend)[2], int t) {
  const int lane = t & 31;
  const int warp = t >> 5;
  if (warp < nq) {
    merge_pending(s_ps + warp * kPendMax, s_pi + warp * kPendMax,
                  pending(pend, warp), cur_s + warp * kt, cur_i + warp * kt,
                  nxt_s + warp * kt, nxt_i + warp * kt, s_cs + warp * kTileItems,
                  s_ci + warp * kTileItems, kt, lane);
  }
  pend[0] = pend[1] = 0u;
  __syncthreads();
}

// One slice of the tiled kernel: candidate j of the calling thread t, acc[qi]
// its score for query qi. A j past N, or excluded (bit ex_bit of
// ex_word[qi * kExWordsTiled] when E > 0), scores -inf and keeps its index.
// The survivors of query qi (keys ranking before its list's last) are counted
// in cnt[qi], zeroed by the caller, and gathered into the pending buffer
// after its pending keys. Then, block-uniformly: a dense slice merges its
// candidates into the lists (pending keys wait on); else the survivors join
// the pending keys, which merge into the lists once some query holds more
// than kTiledSparseMax. A merge writes list buffer cur ^ 1, flips cur and
// ends with a barrier; a slice that only gathers has one barrier.
__device__ __forceinline__ void select_slice(
    float (&acc)[kTileQueries], int j, int N, int nq, int kt, int E,
    bool fresh, const unsigned* ex_word, int ex_bit, float* s_cs, int* s_ci,
    float* s_ls, int* s_li, float* s_ps, int* s_pi, int* cnt,
    unsigned (&pend)[2], int& cur, int t) {
  const int lane = t & 31;
  const float* cur_s = s_ls + cur * kTileQueries * kt;
  const int* cur_i = s_li + cur * kTileQueries * kt;
  float* nxt_s = s_ls + (cur ^ 1) * kTileQueries * kt;
  int* nxt_i = s_li + (cur ^ 1) * kTileQueries * kt;
#pragma unroll
  for (int qi = 0; qi < kTileQueries; ++qi) {
    if (qi < nq) {
      float s = j < N ? acc[qi] : -CUDART_INF_F;
      if (E > 0 && ((ex_word[qi * kExWordsTiled] >> ex_bit) & 1u)) {
        s = -CUDART_INF_F;
      }
      acc[qi] = s;
      const bool keep = before(s, j, cur_s[qi * kt + kt - 1],
                               cur_i[qi * kt + kt - 1]);
      const unsigned m = __ballot_sync(kFullWarp, keep);
      if (m != 0u) {
        int base = 0;
        if (lane == 0) base = atomicAdd(&cnt[qi], __popc(m));
        base = __shfl_sync(kFullWarp, base, 0);
        const int p = pending(pend, qi) + base + __popc(m & ((1u << lane) - 1u));
        if (keep && p < kPendMax) {  // a dense slice's survivors are dropped
          s_ps[qi * kPendMax + p] = s;
          s_pi[qi * kPendMax + p] = j;
        }
      }
    }
  }
  __syncthreads();

  int n_max = 0;
  for (int qi = 0; qi < nq; ++qi) n_max = max(n_max, cnt[qi]);
  if (n_max > kTiledSparseMax) {
    dense_slice(acc, j, nq, kt, fresh, s_cs, s_ci, cur_s, cur_i, nxt_s, nxt_i, t);
    __syncthreads();
    cur ^= 1;
    return;
  }
  int p_max = 0;
#pragma unroll
  for (int qi = 0; qi < kTileQueries; ++qi) {
    if (qi < nq) {
      if (qi < 4) pend[0] += static_cast<unsigned>(cnt[qi]) << (8 * qi);
      else pend[1] += static_cast<unsigned>(cnt[qi]) << (8 * (qi - 4));
    }
    p_max = max(p_max, pending(pend, qi));
  }
  if (p_max > kTiledSparseMax) {
    flush_pending(nq, kt, s_cs, s_ci, cur_s, cur_i, nxt_s, nxt_i, s_ps, s_pi,
                  pend, t);
    cur ^= 1;
  }
}

// Shared memory of topk_run_kernel, in bytes (the launch plan computes the
// same number).
__host__ __device__ constexpr int run_smem_bytes(int R, int kt) {
  return 4 * (kTileQueries * R + kRankChunk * kItemStride +
              4 * kTileQueries * kTileItems + 4 * kTileQueries * kt +
              kTileQueries + kTileQueries * (kTileItems / 32));
}

__global__ void __launch_bounds__(kTileItems)
topk_run_kernel(const float* __restrict__ q, const float* __restrict__ items,
                const int* __restrict__ excl, int B, int N, int R, int E,
                int kt, int n_tiles, int T, int n_runs,
                float* __restrict__ cand_s, int* __restrict__ cand_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_qT = reinterpret_cast<float*>(smem);             // [R][8]
  float* s_items = s_qT + kTileQueries * R;                 // [16][257]
  float* s_cs = s_items + kRankChunk * kItemStride;         // [2][8][256]
  int* s_ci = reinterpret_cast<int*>(s_cs + 2 * kTileQueries * kTileItems);
  float* s_ls = reinterpret_cast<float*>(s_ci + 2 * kTileQueries * kTileItems);
  int* s_li = reinterpret_cast<int*>(s_ls + 2 * kTileQueries * kt);  // [2][8][kt]
  int* s_cnt = s_li + 2 * kTileQueries * kt;                // [8]
  unsigned* s_ex = reinterpret_cast<unsigned*>(s_cnt + kTileQueries);  // [8][8]

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int run = blockIdx.x;
  const int q0 = blockIdx.y * kTileQueries;
  const int nq = min(kTileQueries, B - q0);  // live query slots of this block

  for (int l = t; l < kTileQueries * R; l += kTileItems) {
    const int r = l >> 3;
    const int qi = l & 7;
    s_qT[l] = qi < nq ? q[(size_t)(q0 + qi) * R + r] : 0.f;
  }
  for (int l = t; l < kTileQueries * kt; l += kTileItems) {
    s_ls[l] = -CUDART_INF_F;
    s_li[l] = kSentinelBase + l % kt;
  }
  int cur = 0;  // which of the two list buffers holds the running lists

  const int tile_end = min(n_tiles, (run + 1) * T);
  float pre[kRankChunk];  // the next rank chunk, on its way to shared memory
  const int rc = chunk_width<kRankChunk>(R);
  load_chunk(pre, items, run * T * kTileItems, N, R, 0, rc, t);
  __syncthreads();

  for (int tile = run * T; tile < tile_end; ++tile) {
    const int item0 = tile * kTileItems;
    const int j = item0 + t;
    // Cleared here, used after the scoring loop's barriers.
    if (t < kTileQueries) s_cnt[t] = 0;
    if (E > 0 && t < kTileQueries * (kTileItems / 32)) s_ex[t] = 0u;

    float acc[kTileQueries];
#pragma unroll
    for (int qi = 0; qi < kTileQueries; ++qi) acc[qi] = 0.f;

    for (int r0 = 0; r0 < R; r0 += kRankChunk) {
      store_chunk(s_items, pre, rc, t);
      __syncthreads();
      // start the loads of the next chunk (of this tile, or the first of the
      // next tile) before the FMAs
      const int r1 = r0 + kRankChunk;
      if (r1 < R) {
        load_chunk(pre, items, item0, N, R, chunk_start<kRankChunk>(R, r1), rc, t);
      } else if (tile + 1 < tile_end) {
        load_chunk(pre, items, item0 + kTileItems, N, R, 0, rc, t);
      }
      const int start = chunk_start<kRankChunk>(R, r0);
      score_chunk(acc, s_items, s_qT, start, r0 - start, rc, nq, t);
      // the barriers below order the last chunk's reads before the next store
      if (r1 < R) __syncthreads();
    }

    if (E > 0) {  // one bit per (query, item of the tile) that is excluded
      for (int l = t; l < nq * E; l += kTileItems) {
        const int qi = l / E;
        const int e = l - qi * E;
        const int x = excl[(size_t)(q0 + qi) * E + e];
        if (x >= item0 && x < item0 + kTileItems) {
          const int d = x - item0;
          atomicOr(&s_ex[qi * (kTileItems / 32) + (d >> 5)], 1u << (d & 31));
        }
      }
      __syncthreads();
    }

    // Mask, test against the threshold, gather the survivors per query.
    const float* cur_s = s_ls + cur * kTileQueries * kt;
    const int* cur_i = s_li + cur * kTileQueries * kt;
    float* nxt_s = s_ls + (cur ^ 1) * kTileQueries * kt;
    int* nxt_i = s_li + (cur ^ 1) * kTileQueries * kt;
#pragma unroll
    for (int qi = 0; qi < kTileQueries; ++qi) {
      if (qi < nq) {
        float s = j < N ? acc[qi] : -CUDART_INF_F;
        if (E > 0 && ((s_ex[qi * (kTileItems / 32) + warp] >> lane) & 1u)) {
          s = -CUDART_INF_F;
        }
        acc[qi] = s;
        const bool keep = before(s, j, cur_s[qi * kt + kt - 1],
                                 cur_i[qi * kt + kt - 1]);
        const unsigned m = __ballot_sync(kFullWarp, keep);
        if (m != 0u) {
          int base = 0;
          if (lane == 0) base = atomicAdd(&s_cnt[qi], __popc(m));
          base = __shfl_sync(kFullWarp, base, 0);
          if (keep) {
            const int p = base + __popc(m & ((1u << lane) - 1u));
            s_cs[qi * kTileItems + p] = s;
            s_ci[qi * kTileItems + p] = j;
          }
        }
      }
    }
    __syncthreads();

    int n_max = 0;
    for (int qi = 0; qi < nq; ++qi) n_max = max(n_max, s_cnt[qi]);

    if (n_max <= kSparseMax) {
      // Sparse tile: warp w merges query w's survivors (in arrival order,
      // ranked by their full key) into its running list.
      if (warp < nq) {
        const int n = s_cnt[warp];
        const float* cs = s_cs + warp * kTileItems;
        const int* ci = s_ci + warp * kTileItems;
        const float* ls = cur_s + warp * kt;
        const int* li = cur_i + warp * kt;
        float* ns = nxt_s + warp * kt;
        int* ni = nxt_i + warp * kt;
        if (lane < n) {
          const float s = cs[lane];
          const int i = ci[lane];
          int rank = count_before(ls, li, kt, s, i);
          for (int u = 0; u < n; ++u) rank += before(cs[u], ci[u], s, i);
          if (rank < kt) {
            ns[rank] = s;
            ni[rank] = i;
          }
        }
        for (int m = lane; m < kt; m += 32) {
          const float s = ls[m];
          const int i = li[m];
          int rank = m;
          for (int u = 0; u < n; ++u) rank += before(cs[u], ci[u], s, i);
          if (rank < kt) {
            ns[rank] = s;
            ni[rank] = i;
          }
        }
      }
    } else {
      // Dense tile: every warp sorts its 32 candidates of each query in
      // registers, best first; the survivors gathered above are dropped.
#pragma unroll
      for (int qi = 0; qi < kTileQueries; ++qi) {
        if (qi < nq) {
          float s = acc[qi];
          int i = j;
#pragma unroll
          for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
            for (int stride = size >> 1; stride > 0; stride >>= 1) {
              const float os = __shfl_xor_sync(kFullWarp, s, stride);
              const int oi = __shfl_xor_sync(kFullWarp, i, stride);
              const bool lower = (lane & stride) == 0;
              const bool best_first = (lane & size) == 0;
              // the lower lane of a best-first pair keeps the better key
              if ((lower == best_first) == before(os, oi, s, i)) {
                s = os;
                i = oi;
              }
            }
          }
          s_cs[qi * kTileItems + t] = s;
          s_ci[qi * kTileItems + t] = i;
        }
      }
      __syncthreads();
      // Warp w merges query w: the eight sorted heads pairwise in three
      // rounds between the two candidate buffers, then the result with the
      // running list.
      if (warp < nq) {
        const int hl = min(kt, 32);
        const float* ls = cur_s + warp * kt;
        const int* li = cur_i + warp * kt;
        float* ns = nxt_s + warp * kt;
        int* ni = nxt_i + warp * kt;
        float* src_s = s_cs + warp * kTileItems;
        int* src_i = s_ci + warp * kTileItems;
        float* dst_s = src_s + kTileQueries * kTileItems;
        int* dst_i = src_i + kTileQueries * kTileItems;
        for (int width = 1; width < kTileItems / 32; width <<= 1) {
          const int cap = min(kt, width * hl);
          const int n_keys = (kTileItems / 32 / width) * cap;
          for (int w = lane; w < n_keys; w += 32) {
            merge_round_key(src_s, src_i, dst_s, dst_i, w, kTileItems / 32, hl,
                            32, kt, width, cap);
          }
          __syncwarp();
          float* fs = src_s; src_s = dst_s; dst_s = fs;
          int* fi = src_i; src_i = dst_i; dst_i = fi;
        }
        // src now holds the tile's best kt keys (8 * hl >= kt)
        for (int m = lane; m < kt; m += 32) {
          float s = src_s[m];
          int i = src_i[m];
          int rank = m + count_before(ls, li, kt, s, i);
          if (rank < kt) {
            ns[rank] = s;
            ni[rank] = i;
          }
          s = ls[m];
          i = li[m];
          rank = m + count_before(src_s, src_i, kt, s, i);
          if (rank < kt) {
            ns[rank] = s;
            ni[rank] = i;
          }
        }
      }
    }
    __syncthreads();
    cur ^= 1;
  }

  const float* fin_s = s_ls + cur * kTileQueries * kt;
  const int* fin_i = s_li + cur * kTileQueries * kt;
  for (int l = t; l < nq * kt; l += kTileItems) {
    const int qi = l / kt;
    const int m = l - qi * kt;
    const size_t o = ((size_t)(q0 + qi) * n_runs + run) * kt + m;
    cand_s[o] = fin_s[l];
    cand_i[o] = fin_i[l];
  }
}

// Shared memory of topk_run_tiled_kernel, in bytes: q rows, the step's rank
// chunk, one candidate buffer, two copies of the running lists, three sets
// of survivor counts (slice g uses set g % 3 and zeroes set (g + 1) % 3, so
// that one barrier a slice suffices), the step's exclusion bits and the
// pending keys.
__host__ __device__ constexpr int run_tiled_smem_bytes(int R, int kt) {
  return 4 * (kTileQueries * R + kTiledChunk * kStepStride +
              2 * kTileQueries * kTileItems + 4 * kTileQueries * kt +
              3 * kTileQueries + kTileQueries * kExWordsTiled +
              2 * kTileQueries * kPendMax);
}

__global__ void __launch_bounds__(kTileItems, kTiledBlocksPerSm)
topk_run_tiled_kernel(const float* __restrict__ q,
                      const float* __restrict__ items,
                      const int* __restrict__ excl, int B, int N, int R, int E,
                      int kt, int n_tiles, int T, int n_runs,
                      float* __restrict__ cand_s, int* __restrict__ cand_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_qT = reinterpret_cast<float*>(smem);              // [R][8]
  float* s_items = s_qT + kTileQueries * R;                  // [8][1028]
  float* s_cs = s_items + kTiledChunk * kStepStride;         // [8][256]
  int* s_ci = reinterpret_cast<int*>(s_cs + kTileQueries * kTileItems);
  float* s_ls = reinterpret_cast<float*>(s_ci + kTileQueries * kTileItems);
  int* s_li = reinterpret_cast<int*>(s_ls + 2 * kTileQueries * kt);  // [2][8][kt]
  int* s_cnt = s_li + 2 * kTileQueries * kt;                 // [3][8]
  unsigned* s_ex = reinterpret_cast<unsigned*>(s_cnt + 3 * kTileQueries);  // [8][32]
  float* s_ps = reinterpret_cast<float*>(s_ex + kTileQueries * kExWordsTiled);
  int* s_pi = reinterpret_cast<int*>(s_ps + kTileQueries * kPendMax);  // [8][128]

  const int t = threadIdx.x;
  const int run = blockIdx.x;
  const int q0 = blockIdx.y * kTileQueries;
  const int nq = min(kTileQueries, B - q0);  // live query slots of this block

  for (int l = t; l < kTileQueries * R; l += kTileItems) {
    const int r = l >> 3;
    const int qi = l & 7;
    s_qT[l] = qi < nq ? q[(size_t)(q0 + qi) * R + r] : 0.f;
  }
  for (int l = t; l < kTileQueries * kt; l += kTileItems) {
    s_ls[l] = -CUDART_INF_F;
    s_li[l] = kSentinelBase + l % kt;
  }
  if (t < 3 * kTileQueries) s_cnt[t] = 0;
  int cur = 0;  // which of the two list buffers holds the running lists
  unsigned pend[2] = {0u, 0u};  // pending keys of each query (8 bits each),
                                // alike in every thread
  int g = 0;  // the slice's set of survivor counts

  // A run is a whole number of steps, or ends with the catalog: a step never
  // takes items of the next run, and items past N are masked.
  const int run_begin = run * T * kTileItems;
  const int run_end = min(n_tiles, (run + 1) * T) * kTileItems;
  float pre[kTiledLoads];  // the next rank chunk, on its way to shared memory
  const int rc = chunk_width<kTiledChunk>(R);
  copy_first_chunk_async(s_items, items, run_begin, N, R, rc, t);

  for (int step0 = run_begin; step0 < run_end; step0 += kStepItems) {
    // Cleared here, set after the scoring loop's barriers.
    if (E > 0) {
      for (int l = t; l < kTileQueries * kExWordsTiled; l += kTileItems) s_ex[l] = 0u;
    }

    float acc[kStepTiles][kTileQueries];
#pragma unroll
    for (int c = 0; c < kStepTiles; ++c) {
#pragma unroll
      for (int qi = 0; qi < kTileQueries; ++qi) acc[c][qi] = 0.f;
    }

    for (int r0 = 0; r0 < R; r0 += kTiledChunk) {
      if (r0 == 0) {
        cp_async_wait_all();  // the first chunk, copied during the last selection
      } else {
        store_step_chunk(s_items, pre, rc, t);
      }
      __syncthreads();
      // start the loads of the step's next chunk before the FMAs
      const int r1 = r0 + kTiledChunk;
      if (r1 < R) {
        load_step_chunk(pre, items, step0, N, R, chunk_start<kTiledChunk>(R, r1),
                        rc, t);
      }
      const int start = chunk_start<kTiledChunk>(R, r0);
      score_step_chunk(acc, s_items, s_qT, start, r0 - start, rc, t);
      if (r1 < R) __syncthreads();
    }
    // every read of the step's last chunk is done: the next step's first
    // chunk may land while the slices are selected
    __syncthreads();
    if (step0 + kStepItems < run_end) {
      copy_first_chunk_async(s_items, items, step0 + kStepItems, N, R, rc, t);
    }

    if (E > 0) {  // one bit per (query, item of the step) that is excluded
      for (int l = t; l < nq * E; l += kTileItems) {
        const int qi = l / E;
        const int e = l - qi * E;
        const int x = excl[(size_t)(q0 + qi) * E + e];
        if (x >= step0 && x < step0 + kStepItems) {
          const int d = x - step0;
          atomicOr(&s_ex[qi * kExWordsTiled + (d >> 5)], 1u << (d & 31));
        }
      }
      __syncthreads();
    }

    // Slice c holds items 4t + c of the step (thread t's c-th item): four
    // selections of 256 candidates, in this order, into the same lists. The
    // loop is unrolled so that a slice's scores die once it is selected.
#pragma unroll
    for (int c = 0; c < kStepTiles; ++c) {
      const int g_next = g == 2 ? 0 : g + 1;
      if (t < kTileQueries) s_cnt[g_next * kTileQueries + t] = 0;
      select_slice(acc[c], step0 + kStepTiles * t + c, N, nq, kt, E,
                   step0 == run_begin && c == 0, s_ex + (t >> 3),
                   kStepTiles * (t & 7) + c, s_cs, s_ci, s_ls, s_li, s_ps, s_pi,
                   s_cnt + g * kTileQueries, pend, cur, t);
      g = g_next;
    }
  }
  if (pend[0] != 0u || pend[1] != 0u) {  // the run's last pending keys
    flush_pending(nq, kt, s_cs, s_ci, s_ls + cur * kTileQueries * kt,
                  s_li + cur * kTileQueries * kt, s_ls + (cur ^ 1) * kTileQueries * kt,
                  s_li + (cur ^ 1) * kTileQueries * kt, s_ps, s_pi, pend, t);
    cur ^= 1;
  }

  const float* fin_s = s_ls + cur * kTileQueries * kt;
  const int* fin_i = s_li + cur * kTileQueries * kt;
  for (int l = t; l < nq * kt; l += kTileItems) {
    const int qi = l / kt;
    const int m = l - qi * kt;
    const size_t o = ((size_t)(q0 + qi) * n_runs + run) * kt + m;
    cand_s[o] = fin_s[l];
    cand_i[o] = fin_i[l];
  }
}

__global__ void __launch_bounds__(kTileItems)
topk_tile_kernel(const float* __restrict__ q, const float* __restrict__ items,
                 const int* __restrict__ excl, int B, int N, int R, int E,
                 int kt, int n_tiles, float* __restrict__ cand_s,
                 int* __restrict__ cand_i) {
  __shared__ float s_items[kRankChunk * kItemStride];
  __shared__ __align__(16) float s_qt[kRankChunk * kTileQueries];  // [rank][query]
  __shared__ float s_key[kTileQueries][kTileItems];
  __shared__ int s_idx[kTileQueries][kTileItems];

  const int t = threadIdx.x;
  const int tile = blockIdx.x;
  const int q0 = blockIdx.y * kTileQueries;
  const int nq = min(kTileQueries, B - q0);  // live query slots of this block
  const int item0 = tile * kTileItems;
  const int j = item0 + t;

  float acc[kTileQueries];
#pragma unroll
  for (int qi = 0; qi < kTileQueries; ++qi) acc[qi] = 0.f;

  const int rc = chunk_width<kRankChunk>(R);
  for (int r0 = 0; r0 < R; r0 += kRankChunk) {
    const int start = chunk_start<kRankChunk>(R, r0);
    float pre[kRankChunk];
    load_chunk(pre, items, item0, N, R, start, rc, t);
    store_chunk(s_items, pre, rc, t);
    for (int l = t; l < kTileQueries * rc; l += kTileItems) {
      const int qi = l & 7;
      s_qt[l] = qi < nq ? q[(size_t)(q0 + qi) * R + start + (l >> 3)] : 0.f;
    }
    __syncthreads();
    score_chunk(acc, s_items, s_qt, 0, r0 - start, rc, nq, t);
    __syncthreads();
  }

#pragma unroll
  for (int qi = 0; qi < kTileQueries; ++qi) {
    if (qi < nq) {
      s_key[qi][t] = j < N ? acc[qi] : -CUDART_INF_F;
      s_idx[qi][t] = j;
    }
  }
  __syncthreads();

  if (E > 0) {
    for (int l = t; l < nq * E; l += kTileItems) {
      const int qi = l / E;
      const int e = l - qi * E;
      const int x = excl[(size_t)(q0 + qi) * E + e];
      if (x >= item0 && x < item0 + kTileItems) {
        s_key[qi][x - item0] = -CUDART_INF_F;
      }
    }
    __syncthreads();
  }

  // Bitonic sort of each live query's row, best first.
  for (int size = 2; size <= kTileItems; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int p = t ^ stride;
      if (p > t) {
        const bool best_first = (t & size) == 0;
#pragma unroll
        for (int qi = 0; qi < kTileQueries; ++qi) {
          if (qi < nq) {
            const float sa = s_key[qi][t];
            const float sb = s_key[qi][p];
            const int ia = s_idx[qi][t];
            const int ib = s_idx[qi][p];
            if (best_first ? before(sb, ib, sa, ia) : before(sa, ia, sb, ib)) {
              s_key[qi][t] = sb;
              s_key[qi][p] = sa;
              s_idx[qi][t] = ib;
              s_idx[qi][p] = ia;
            }
          }
        }
      }
      __syncthreads();
    }
  }

  for (int l = t; l < nq * kt; l += kTileItems) {
    const int qi = l / kt;
    const int m = l - qi * kt;
    const size_t o = ((size_t)(q0 + qi) * n_tiles + tile) * kt + m;
    cand_s[o] = s_key[qi][m];
    cand_i[o] = s_idx[qi][m];
  }
}

// Stage 2 in shared memory: one block per query. The query's n_runs sorted
// lists of kt keys sit side by side in cand; round `width` merges the nodes
// of `width` leaves in pairs (merge_round_key), first from cand into one
// shared buffer, then between the two shared buffers, a barrier after each
// round. The pointers carry no __restrict__: a round reads what the round
// before wrote.
__global__ void __launch_bounds__(kMergeThreadsLarge)
topk_merge_kernel(const float* cand_s, const int* cand_i, int n_runs, int kt,
                  int K, float* out_s, int* out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const size_t span = (size_t)n_runs * kt;

  const float* src_s = cand_s + blockIdx.x * span;
  const int* src_i = cand_i + blockIdx.x * span;
  float* a_s = reinterpret_cast<float*>(smem);
  int* a_i = reinterpret_cast<int*>(a_s + span);
  float* b_s = reinterpret_cast<float*>(a_i + span);
  int* b_i = reinterpret_cast<int*>(b_s + span);
  float* dst_s = a_s;
  int* dst_i = a_i;

  for (int width = 1; width < n_runs; width <<= 1) {
    const int cap = min(K, width * kt);
    const int n_keys = ((n_runs + width - 1) / width) * cap;
    for (int w = t; w < n_keys; w += nt) {
      merge_round_key(src_s, src_i, dst_s, dst_i, w, n_runs, kt, kt, K, width, cap);
    }
    __syncthreads();
    src_s = dst_s;
    src_i = dst_i;
    dst_s = dst_s == a_s ? b_s : a_s;
    dst_i = dst_i == a_i ? b_i : a_i;
  }

  const size_t o = (size_t)blockIdx.x * K;
  for (int m = t; m < K; m += nt) {
    const float s = src_s[m];
    out_s[o + m] = s;
    out_i[o + m] = s == -CUDART_INF_F ? -1 : src_i[m];
  }
}

// Stage 2 in device memory, for lists too long for shared memory: one launch
// per round, the keys of a round spread over grid.y blocks per query
// (blockIdx.x), so a few long queries still fill the card.
__global__ void __launch_bounds__(kMergeThreads)
topk_merge_round_kernel(const float* __restrict__ src_s,
                        const int* __restrict__ src_i, float* __restrict__ dst_s,
                        int* __restrict__ dst_i, int n_runs, int kt, int K,
                        int width, int cap, int n_keys) {
  const size_t base = (size_t)blockIdx.x * n_runs * kt;
  for (int w = blockIdx.y * kMergeThreads + threadIdx.x; w < n_keys;
       w += gridDim.y * kMergeThreads) {
    merge_round_key(src_s + base, src_i + base, dst_s + base, dst_i + base, w,
                    n_runs, kt, kt, K, width, cap);
  }
}

// The last write: the K best keys of each query, -inf turned into index -1.
__global__ void __launch_bounds__(kMergeThreads)
topk_store_kernel(const float* __restrict__ src_s, const int* __restrict__ src_i,
                  int n_runs, int kt, int K, float* __restrict__ out_s,
                  int* __restrict__ out_i) {
  const size_t base = (size_t)blockIdx.x * n_runs * kt;
  const size_t o = (size_t)blockIdx.x * K;
  for (int m = blockIdx.y * kMergeThreads + threadIdx.x; m < K;
       m += gridDim.y * kMergeThreads) {
    const float s = src_s[base + m];
    out_s[o + m] = s;
    out_i[o + m] = s == -CUDART_INF_F ? -1 : src_i[base + m];
  }
}

// ---- The select path (k > 256) ----------------------------------------------
// The canonical score (-0.0 as +0.0: before() treats them as equal, their bits
// differ) as a 32-bit key whose unsigned order is the scores' order; and back.
__device__ __forceinline__ float canonical(float s) { return s == 0.f ? 0.f : s; }

__device__ __forceinline__ unsigned order_key(float s) {
  const unsigned u = __float_as_uint(canonical(s));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_score(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// A survivor as one 8-byte key whose ascending order is the contract's:
// score descending, then index ascending.
__device__ __forceinline__ unsigned long long pack_key(unsigned key, int j) {
  return (static_cast<unsigned long long>(~key) << 32) | static_cast<unsigned>(j);
}

// The select path's scoring: one block per (8-query tile x run of T tiles,
// T a multiple of kStepTiles or the whole catalog), scored as
// topk_run_tiled_kernel scores: a step of 1,024 items, 4 consecutive items x 8
// queries a thread (one 16-byte item load and two q broadcasts a rank), the
// step's ranks 8 at a time, its first chunk copied by cp.async while the step
// before is stored and counted. Each live score is masked (-inf when
// excluded), canonicalised, stored to its query's row of `scores` (row stride
// ld; 16 bytes a thread a query) and counted in the query's histogram of
// top-11-bit keys in shared memory; items past N are neither stored nor
// counted. The block then adds its counts to `hist` ([B][kSelectBins], zeroed
// by the entry) with integer atomics, so the sums are exact in any order.
__global__ void __launch_bounds__(kTileItems, kSelectScoreBlocksPerSm)
topk_select_score_kernel(const float* __restrict__ q,
                         const float* __restrict__ items,
                         const int* __restrict__ excl, int B, int N, int R,
                         int E, int n_tiles, int T, int ld,
                         float* __restrict__ scores, unsigned* __restrict__ hist) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_qT = reinterpret_cast<float*>(smem);              // [R][8]
  float* s_items = s_qT + kTileQueries * R;                  // [8][1028]
  unsigned* s_hist = reinterpret_cast<unsigned*>(s_items + kTiledChunk * kStepStride);
  unsigned* s_ex = s_hist + kTileQueries * kSelectBins;      // [8][32]

  const int t = threadIdx.x;
  const int run = blockIdx.x;
  const int q0 = blockIdx.y * kTileQueries;
  const int nq = min(kTileQueries, B - q0);  // live query slots of this block

  for (int l = t; l < kTileQueries * R; l += kTileItems) {
    const int r = l >> 3;
    const int qi = l & 7;
    s_qT[l] = qi < nq ? q[(size_t)(q0 + qi) * R + r] : 0.f;
  }
  for (int l = t; l < nq * kSelectBins; l += kTileItems) s_hist[l] = 0u;

  // A run is a whole number of steps, or ends with the catalog: a step never
  // takes items of the next run, and items past N are masked.
  const int run_begin = run * T * kTileItems;
  const int run_end = min(n_tiles, (run + 1) * T) * kTileItems;
  float pre[kTiledLoads];  // the next rank chunk, on its way to shared memory
  const int rc = chunk_width<kTiledChunk>(R);
  copy_first_chunk_async(s_items, items, run_begin, N, R, rc, t);

  for (int step0 = run_begin; step0 < run_end; step0 += kStepItems) {
    // Cleared here, set after the scoring loop's barriers.
    if (E > 0) {
      for (int l = t; l < kTileQueries * kExWordsTiled; l += kTileItems) s_ex[l] = 0u;
    }

    float acc[kStepTiles][kTileQueries];
#pragma unroll
    for (int c = 0; c < kStepTiles; ++c) {
#pragma unroll
      for (int qi = 0; qi < kTileQueries; ++qi) acc[c][qi] = 0.f;
    }

    for (int r0 = 0; r0 < R; r0 += kTiledChunk) {
      if (r0 == 0) {
        cp_async_wait_all();  // the first chunk, copied during the last step's stores
      } else {
        store_step_chunk(s_items, pre, rc, t);
      }
      __syncthreads();
      const int r1 = r0 + kTiledChunk;
      if (r1 < R) {
        load_step_chunk(pre, items, step0, N, R, chunk_start<kTiledChunk>(R, r1), rc, t);
      }
      const int start = chunk_start<kTiledChunk>(R, r0);
      score_step_chunk(acc, s_items, s_qT, start, r0 - start, rc, t);
      if (r1 < R) __syncthreads();
    }
    // every read of the step's last chunk is done: the next step's first
    // chunk may land while this step's scores are stored and counted
    __syncthreads();
    if (step0 + kStepItems < run_end) {
      copy_first_chunk_async(s_items, items, step0 + kStepItems, N, R, rc, t);
    }

    if (E > 0) {  // one bit per (query, item of the step) that is excluded
      for (int l = t; l < nq * E; l += kTileItems) {
        const int qi = l / E;
        const int e = l - qi * E;
        const int x = excl[(size_t)(q0 + qi) * E + e];
        if (x >= step0 && x < step0 + kStepItems) {
          const int d = x - step0;
          atomicOr(&s_ex[qi * kExWordsTiled + (d >> 5)], 1u << (d & 31));
        }
      }
      __syncthreads();
    }

    const int j0 = step0 + kStepTiles * t;  // this thread's 4 items
#pragma unroll
    for (int qi = 0; qi < kTileQueries; ++qi) {
      if (qi < nq) {
        float v[kStepTiles];
#pragma unroll
        for (int c = 0; c < kStepTiles; ++c) {
          float s = acc[c][qi];
          if (E > 0 && ((s_ex[qi * kExWordsTiled + (t >> 3)] >> (kStepTiles * (t & 7) + c)) & 1u)) {
            s = -CUDART_INF_F;
          }
          v[c] = canonical(s);
        }
        float* dst = scores + (size_t)(q0 + qi) * ld + j0;
        if (j0 + kStepTiles <= N) {
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int c = 0; c < kStepTiles; ++c) {
            if (j0 + c < N) dst[c] = v[c];
          }
        }
#pragma unroll
        for (int c = 0; c < kStepTiles; ++c) {
          if (j0 + c < N) atomicAdd(&s_hist[qi * kSelectBins + (order_key(v[c]) >> 21)], 1u);
        }
      }
    }
    // the step's exclusion bits are read before the next step clears them
    if (E > 0) __syncthreads();
  }

  __syncthreads();
  for (int l = t; l < nq * kSelectBins; l += kTileItems) {
    const unsigned v = s_hist[l];
    if (v != 0u) atomicAdd(&hist[(size_t)q0 * kSelectBins + l], v);
  }
}

// The exclusive prefix sum of v over the block's threads in thread order, and
// the block's total in *total. s_warp holds 32 words; ends with a barrier, so
// that the block may call it again at once.
__device__ __forceinline__ unsigned block_exclusive_sum(unsigned v, unsigned* s_warp,
                                                        unsigned* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFullWarp, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < n_warps ? s_warp[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFullWarp, w, o);
      if (lane >= o) w += y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  const unsigned before_me = (warp > 0 ? s_warp[warp - 1] : 0u) + x - v;
  *total = s_warp[n_warps - 1];
  __syncthreads();
  return before_me;
}

// The bin of the histogram s_h (nb counts in shared memory) that holds the
// need-th key counted from the top bin down, into res[0], and how many keys
// the bins above it hold, into res[1]. The histogram holds at least need >= 1
// keys. Thread t sums nb / blockDim bins from the top, the sums are scanned,
// and the one thread whose bins reach need finds the bin (res stays (0, 0)
// on a histogram that does not hold need keys, so nothing reads out of
// bounds). Ends with a barrier.
__device__ __forceinline__ void find_boundary(const unsigned* s_h, int nb,
                                              unsigned need, unsigned* s_warp,
                                              unsigned* res) {
  if (threadIdx.x == 0) res[0] = res[1] = 0u;  // ordered by the scan's barriers
  const int per = nb / blockDim.x;
  const int top = nb - 1 - threadIdx.x * per;  // this thread's highest bin
  unsigned sum = 0u;
  for (int i = 0; i < per; ++i) sum += s_h[top - i];
  unsigned total;
  unsigned above = block_exclusive_sum(sum, s_warp, &total);
  if (above < need && above + sum >= need) {
    for (int i = 0; i < per; ++i) {
      const unsigned c = s_h[top - i];
      if (above + c >= need) {
        res[0] = static_cast<unsigned>(top - i);
        res[1] = above;
        break;
      }
      above += c;
    }
  }
  __syncthreads();
}

// A select block walks a query's row kRowLoads 16-byte pieces a thread a
// pass, all loads issued before any is used (a pass at N = 27,000 is two
// round trips to memory, not 27): piece u of thread t in the pass from base
// starts at base + 4 (t + u blockDim). Keys past N read as 0 and are masked.
constexpr int kRowLoads = 4;

__device__ __forceinline__ void load_row(float (&v)[4 * kRowLoads], const float* row,
                                         int N, int base) {
#pragma unroll
  for (int u = 0; u < kRowLoads; ++u) {
    const int j4 = base + 4 * (threadIdx.x + u * blockDim.x);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j4 < N) x = *reinterpret_cast<const float4*>(row + j4);
    v[4 * u] = x.x;
    v[4 * u + 1] = x.y;
    v[4 * u + 2] = x.z;
    v[4 * u + 3] = x.w;
  }
}

// The index of key e (0..15) of the calling thread's pass from base.
__device__ __forceinline__ int row_index(int base, int e) {
  return base + 4 * (threadIdx.x + (e >> 2) * blockDim.x) + (e & 3);
}

// Counts into s_h the keys of the row whose bits from `shift` up equal
// `prefix`, by their next bits: those from `sub` up to `shift`.
__device__ __forceinline__ void refine_counts(const float* row, int N, unsigned prefix,
                                              int shift, int sub, unsigned* s_h) {
  const unsigned mask = (1u << (shift - sub)) - 1u;
  for (int base = 0; base < N; base += 4 * kRowLoads * blockDim.x) {
    float v[4 * kRowLoads];
    load_row(v, row, N, base);
#pragma unroll
    for (int e = 0; e < 4 * kRowLoads; ++e) {
      const unsigned key = order_key(v[e]);
      if (row_index(base, e) < N && (key >> shift) == prefix) {
        atomicAdd(&s_h[(key >> sub) & mask], 1u);
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned long long min64(unsigned long long a,
                                                    unsigned long long b) {
  return a < b ? a : b;
}
__device__ __forceinline__ unsigned long long max64(unsigned long long a,
                                                    unsigned long long b) {
  return a < b ? b : a;
}

// The stages of one bitonic merge of `size` with strides from `top` down to 1
// on the 256 keys of one segment, held 8 a lane (global index g0 + lane + 32 h
// in v[h]): strides of 32 and more between a lane's own keys, the others by
// shuffles. A pair ascends when its global index has the `size` bit clear.
__device__ __forceinline__ void segment_stages(unsigned long long (&v)[8], int lane,
                                               int g0, int size, int top) {
#pragma unroll
  for (int stride = kSortSegment / 2; stride > 0; stride >>= 1) {
    if (stride > top) continue;
    if (stride >= 32) {
#pragma unroll
      for (int h = 0; h < 8; ++h) {
        const int g = h ^ (stride >> 5);
        if (g > h) {
          const bool up = ((g0 + 32 * h + lane) & size) == 0;
          const unsigned long long lo = min64(v[h], v[g]);
          const unsigned long long hi = max64(v[h], v[g]);
          v[h] = up ? lo : hi;
          v[g] = up ? hi : lo;
        }
      }
    } else {
#pragma unroll
      for (int h = 0; h < 8; ++h) {
        const unsigned long long o = __shfl_xor_sync(kFullWarp, v[h], stride);
        const bool up = ((g0 + 32 * h + lane) & size) == 0;
        const bool lower = (lane & stride) == 0;
        v[h] = (lower == up) ? min64(v[h], o) : max64(v[h], o);
      }
    }
  }
}

// Sorts s[0..P) ascending in place, P a power of two >= kSortMin, with a
// bitonic network: each warp sorts 256-key segments in registers (merge
// sizes 2..256, no block barrier), then for each merge size from 512 up the
// strides of 256 and more run across the block in shared memory, a barrier
// after each, and the strides below 256 in registers again, a segment a warp.
__device__ __forceinline__ void block_sort(unsigned long long* s, int P) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int n_warps = blockDim.x >> 5;
  const int segs = P / kSortSegment;
  for (int seg = t >> 5; seg < segs; seg += n_warps) {
    unsigned long long v[8];
    const int g0 = seg * kSortSegment;
#pragma unroll
    for (int h = 0; h < 8; ++h) v[h] = s[g0 + lane + 32 * h];
#pragma unroll
    for (int size = 2; size <= kSortSegment; size <<= 1) {
      segment_stages(v, lane, g0, size, size >> 1);
    }
#pragma unroll
    for (int h = 0; h < 8; ++h) s[g0 + lane + 32 * h] = v[h];
  }
  __syncthreads();
  for (int size = 2 * kSortSegment; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride >= kSortSegment; stride >>= 1) {
      for (int i = t; i < P / 2; i += blockDim.x) {
        const int a = 2 * (i & ~(stride - 1)) + (i & (stride - 1));
        const unsigned long long x = s[a];
        const unsigned long long y = s[a + stride];
        const bool up = (a & size) == 0;
        if (up ? y < x : x < y) {
          s[a] = y;
          s[a + stride] = x;
        }
      }
      __syncthreads();
    }
    for (int seg = t >> 5; seg < segs; seg += n_warps) {
      unsigned long long v[8];
      const int g0 = seg * kSortSegment;
#pragma unroll
      for (int h = 0; h < 8; ++h) v[h] = s[g0 + lane + 32 * h];
      segment_stages(v, lane, g0, size, kSortSegment / 2);
#pragma unroll
      for (int h = 0; h < 8; ++h) s[g0 + lane + 32 * h] = v[h];
    }
    __syncthreads();
  }
}

// The select path's selection: one block per query over its row of scores.
//   1. The boundary: the bin of the top-11-bit histogram that holds the k-th
//      key (counted from the top), and the count of keys above it. If the keys
//      from that bin up do not fit the `cap` survivors, the bin's keys are
//      counted again on the next 11 bits (a pass over the row), and if still
//      not, on the last 10: the boundary is then the k-th key itself.
//   2. The gather: every key from the boundary's bits up (at an exact key, every
//      key above it) joins the survivors, in any order (a warp-aggregated
//      counter), as a packed key; at an exact key, the keys equal to it are
//      then taken in index order (a block scan a chunk of the row, no atomics)
//      until k survivors are held.
//   3. The survivors, padded with the largest key to a power of two, are
//      sorted in shared memory (block_sort); the first K are stored, -inf
//      with index -1.
__global__ void __launch_bounds__(kSelectThreads)
topk_select_kernel(const float* __restrict__ scores,
                   const unsigned* __restrict__ hist, int N, int ld, int K, int cap,
                   float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* s_keys = reinterpret_cast<unsigned long long*>(smem);  // [cap]
  unsigned* s_hist = reinterpret_cast<unsigned*>(s_keys + cap);  // [kSelectBins]
  unsigned* s_warp = s_hist + kSelectBins;  // [32] block scan
  unsigned* s_res = s_warp + 32;            // [2] boundary bin, keys above it
  unsigned* s_cnt = s_res + 2;              // [1] survivors gathered

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int nt = blockDim.x;
  const size_t b = blockIdx.x;
  const float* row = scores + b * ld;

  for (int l = t; l < kSelectBins; l += nt) s_hist[l] = hist[b * kSelectBins + l];
  if (t == 0) *s_cnt = 0u;
  __syncthreads();
  find_boundary(s_hist, kSelectBins, K, s_warp, s_res);
  unsigned prefix = s_res[0];  // the boundary's bits so far
  unsigned above = s_res[1];   // keys whose bits rank above the prefix
  unsigned count = above + s_hist[prefix];
  int shift = 21;  // the survivors: keys with (key >> shift) >= prefix
  if (count > static_cast<unsigned>(cap)) {  // the next 11 bits
    __syncthreads();
    for (int l = t; l < kSelectBins; l += nt) s_hist[l] = 0u;
    __syncthreads();
    refine_counts(row, N, prefix, 21, 10, s_hist);
    find_boundary(s_hist, kSelectBins, K - above, s_warp, s_res);
    const unsigned bin = s_res[0];
    prefix = (prefix << 11) | bin;
    above += s_res[1];
    count = above + s_hist[bin];
    shift = 10;
    if (count > static_cast<unsigned>(cap)) {  // the last 10 bits: the key itself
      __syncthreads();
      for (int l = t; l < kSelectLastBins; l += nt) s_hist[l] = 0u;
      __syncthreads();
      refine_counts(row, N, prefix, 10, 0, s_hist);
      find_boundary(s_hist, kSelectLastBins, K - above, s_warp, s_res);
      prefix = (prefix << 10) | s_res[0];
      above += s_res[1];
      count = K;
      shift = 0;
    }
  }
  const bool exact = shift == 0;

  // Gather: 16 keys a thread a pass, one counter add a warp a pass.
  for (int base = 0; base < N; base += 4 * kRowLoads * nt) {
    float v[4 * kRowLoads];
    load_row(v, row, N, base);
    unsigned keys[4 * kRowLoads];
    unsigned mine = 0u;
#pragma unroll
    for (int c = 0; c < 4 * kRowLoads; ++c) {
      keys[c] = order_key(v[c]);
      const bool take = row_index(base, c) < N &&
                        (exact ? keys[c] > prefix : (keys[c] >> shift) >= prefix);
      mine |= static_cast<unsigned>(take) << c;
    }
    const unsigned n_mine = __popc(mine);
    unsigned x = n_mine;  // inclusive scan of the warp's counts
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFullWarp, x, o);
      if (lane >= o) x += y;
    }
    unsigned pos = 0u;
    if (lane == 31 && x != 0u) pos = atomicAdd(s_cnt, x);
    pos = __shfl_sync(kFullWarp, pos, 31) + x - n_mine;
#pragma unroll
    for (int c = 0; c < 4 * kRowLoads; ++c) {
      if ((mine >> c) & 1u) {
        if (pos < static_cast<unsigned>(cap)) s_keys[pos] = pack_key(keys[c], row_index(base, c));
        ++pos;
      }
    }
  }
  __syncthreads();
  if (exact) {  // the keys equal to the k-th, lowest indices first
    const unsigned need = K - above;
    unsigned taken = 0u;
    for (int base = 0; base < N && taken < need; base += nt) {
      const int j = base + t;
      const bool tie = j < N && order_key(row[j]) == prefix;
      unsigned total;
      const unsigned rank = block_exclusive_sum(tie ? 1u : 0u, s_warp, &total);
      const unsigned at = above + taken + rank;
      if (tie && taken + rank < need && at < static_cast<unsigned>(cap)) {
        s_keys[at] = pack_key(prefix, j);
      }
      taken += total;
    }
    __syncthreads();
  }

  int P = kSortMin;  // the counts are exact, so count <= cap; P never passes cap
  while (P < static_cast<int>(count) && P < cap) P <<= 1;
  for (int l = min(static_cast<int>(count), P) + t; l < P; l += nt) s_keys[l] = ~0ull;
  __syncthreads();
  block_sort(s_keys, P);

  const size_t o = b * K;
  for (int m = t; m < K; m += nt) {
    const unsigned long long sk = s_keys[m];
    const float s = key_score(~static_cast<unsigned>(sk >> 32));
    out_s[o + m] = s;
    out_i[o + m] = s == -CUDART_INF_F ? -1 : static_cast<int>(static_cast<unsigned>(sk));
  }
}

// Opts `kernel` into `bytes` of dynamic shared memory on the current device,
// once per device and size (granted[] remembers the largest size set).
template <typename Kernel>
cudaError_t allow_shared_memory(Kernel kernel, int bytes, int* granted) {
  if (bytes <= kOptInFrom) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && granted[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && known) granted[dev] = bytes;
  return err;
}

int g_run_smem[kMaxDevices];
int g_run_tiled_smem[kMaxDevices];

// The tiled kernel's launch setup, once per device: its dynamic shared memory
// and the largest shared-memory carveout, so that kTiledBlocksPerSm blocks of
// about 107 KB fit an SM.
cudaError_t prepare_run_tiled(int bytes) {
  cudaError_t err = allow_shared_memory(topk_run_tiled_kernel, bytes, g_run_tiled_smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(topk_run_tiled_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              static_cast<int>(cudaSharedmemCarveoutMaxShared));
}
int g_merge_smem[kMaxDevices];
int g_select_score_smem[kMaxDevices];
int g_select_smem[kMaxDevices];

}  // namespace

// Launches the stages on `stream` and returns the first CUDA error (0 = ok).
// Pointers are device pointers: q [B, R] f32, items [N, R] f32, excl [B, E]
// i32 (may be null when E == 0), scratch cand_s/cand_i [B, n_runs, kt], a
// second scratch alt_s/alt_i of the same shape (may be null when the merge
// runs in shared memory), outputs out_s/out_i [B, K]. The rest is the launch
// plan of ops/cuda_kernels.py::topk_launch_plan, which is checked here:
//   kt = min(K, 256); n_tiles = ceil(N / 256); T tiles per stage-1 block and
//   n_runs = ceil(n_tiles / T) lists per query; stage1 the stage-1 kernel
//   (kStage1TileSort: topk_tile_kernel, T = 1, stage1_smem = 0;
//   kStage1Run: topk_run_kernel; kStage1RunTiled: topk_run_tiled_kernel, T a
//   multiple of 4 or n_tiles; a running list keeps kt = K keys, so both take
//   K <= kRunMaxKt) and
//   stage1_smem its dynamic shared memory; merge_smem = 16 * n_runs * kt when
//   the merge rounds run in shared memory (one launch, merge_threads a power
//   of two from 32 to 1024), or 0 when they run between the two scratches (one
//   launch per round).
// Anything else returns cudaErrorInvalidValue and launches nothing.
constexpr int kStage1TileSort = 0;
constexpr int kStage1Run = 1;
constexpr int kStage1RunTiled = 2;

extern "C" int pio_topk_streaming(const void* q, const void* items,
                                  const void* excl, int B, int N, int R, int E,
                                  int K, int kt, int n_tiles, int T, int n_runs,
                                  int stage1, int stage1_smem, int merge_smem,
                                  int merge_threads, void* cand_s, void* cand_i,
                                  void* alt_s, void* alt_i, void* out_s,
                                  void* out_i, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || N < 1 || R < 1 || E < 0 || K < 1 || K > kMaxK || K > N ||
      kt != (K < kTileItems ? K : kTileItems) ||
      n_tiles != (N + kTileItems - 1) / kTileItems || T < 1 || T > n_tiles ||
      n_runs != (n_tiles + T - 1) / T ||
      B > kTileQueries * 65535 || (E > 0 && excl == nullptr)) {
    return invalid;
  }
  const long long span = static_cast<long long>(n_runs) * kt;
  if (span > (1 << 29)) return invalid;  // the merge indexes keys with ints
  if (stage1 == kStage1TileSort) {
    if (T != 1 || stage1_smem != 0) return invalid;
  } else if (stage1 == kStage1Run) {
    if (K > kRunMaxKt || stage1_smem != run_smem_bytes(R, kt) ||
        stage1_smem > kMaxSmem) {
      return invalid;
    }
  } else if (stage1 == kStage1RunTiled) {
    if (K > kRunMaxKt || stage1_smem != run_tiled_smem_bytes(R, kt) ||
        stage1_smem > kMaxSmem || (T % kStepTiles != 0 && T != n_tiles)) {
      return invalid;
    }
  } else {
    return invalid;
  }
  if (merge_smem == 0) {
    if (n_runs > 1 && (alt_s == nullptr || alt_i == nullptr)) return invalid;
  } else if (merge_smem != 16 * span || merge_smem > kMaxSmem ||
             merge_threads < 32 || merge_threads > kMergeThreadsLarge ||
             (merge_threads & (merge_threads - 1)) != 0) {
    return invalid;
  }

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid1(n_runs, (B + kTileQueries - 1) / kTileQueries);
  cudaError_t err;
  const float* qf = static_cast<const float*>(q);
  const float* itf = static_cast<const float*>(items);
  const int* ex = static_cast<const int*>(excl);
  float* cs = static_cast<float*>(cand_s);
  int* ci = static_cast<int*>(cand_i);
  if (stage1 == kStage1Run) {
    err = allow_shared_memory(topk_run_kernel, stage1_smem, g_run_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    topk_run_kernel<<<grid1, kTileItems, stage1_smem, s>>>(
        qf, itf, ex, B, N, R, E, kt, n_tiles, T, n_runs, cs, ci);
  } else if (stage1 == kStage1RunTiled) {
    err = prepare_run_tiled(stage1_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    topk_run_tiled_kernel<<<grid1, kTileItems, stage1_smem, s>>>(
        qf, itf, ex, B, N, R, E, kt, n_tiles, T, n_runs, cs, ci);
  } else {
    topk_tile_kernel<<<grid1, kTileItems, 0, s>>>(qf, itf, ex, B, N, R, E, kt,
                                                  n_tiles, cs, ci);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (merge_smem != 0) {
    err = allow_shared_memory(topk_merge_kernel, merge_smem, g_merge_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    topk_merge_kernel<<<B, merge_threads, merge_smem, s>>>(
        static_cast<const float*>(cand_s), static_cast<const int*>(cand_i),
        n_runs, kt, K, static_cast<float*>(out_s), static_cast<int*>(out_i));
    return static_cast<int>(cudaGetLastError());
  }
  float* src_s = static_cast<float*>(cand_s);
  int* src_i = static_cast<int*>(cand_i);
  float* dst_s = static_cast<float*>(alt_s);
  int* dst_i = static_cast<int*>(alt_i);
  for (int width = 1; width < n_runs; width <<= 1) {
    const long long wide = static_cast<long long>(width) * kt;
    const int cap = wide < K ? static_cast<int>(wide) : K;
    const int n_keys = ((n_runs + width - 1) / width) * cap;
    const int blocks = (n_keys + kMergeThreads - 1) / kMergeThreads;
    const dim3 grid(B, blocks < 65535 ? blocks : 65535);
    topk_merge_round_kernel<<<grid, kMergeThreads, 0, s>>>(
        src_s, src_i, dst_s, dst_i, n_runs, kt, K, width, cap, n_keys);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    float* fs = src_s; src_s = dst_s; dst_s = fs;
    int* fi = src_i; src_i = dst_i; dst_i = fi;
  }
  const int store_blocks = (K + kMergeThreads - 1) / kMergeThreads;
  const dim3 grid(B, store_blocks < 65535 ? store_blocks : 65535);
  topk_store_kernel<<<grid, kMergeThreads, 0, s>>>(
      src_s, src_i, n_runs, kt, K, static_cast<float*>(out_s),
      static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

// The select path (256 < K <= kSelectMaxKeys by the plan's pick; any K up to
// it when forced): scores [B, ld] f32 and hist [B, kSelectBins] u32 are the
// scratch (hist is zeroed here), the rest as pio_topk_streaming's. The plan
// (ops/cuda_kernels.py::topk_launch_plan, stage1 "select") is checked here:
// n_tiles = ceil(N / 256), T tiles a scoring block (a multiple of kStepTiles,
// or n_tiles), n_runs = ceil(n_tiles / T), ld = N rounded up to 4, score_smem = select_score_smem_bytes(R),
// survivors a power of two from max(K, kSortMin) to kSelectMaxKeys and
// select_smem = select_smem_bytes(survivors). Anything else returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int pio_topk_select(const void* q, const void* items, const void* excl,
                               int B, int N, int R, int E, int K, int n_tiles,
                               int T, int n_runs, int ld, int score_smem,
                               int select_smem, int survivors, void* scores,
                               void* hist, void* out_s, void* out_i,
                               void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || N < 1 || R < 1 || E < 0 || K < 1 || K > N || N > kMaxK ||
      K > kSelectMaxKeys || n_tiles != (N + kTileItems - 1) / kTileItems ||
      T < 1 || T > n_tiles || n_runs != (n_tiles + T - 1) / T ||
      (T % kStepTiles != 0 && T != n_tiles) ||
      ld != ((N + 3) & ~3) || B > kTileQueries * 65535 ||
      (E > 0 && excl == nullptr) || score_smem != select_score_smem_bytes(R) ||
      score_smem > kMaxSmem || survivors < K || survivors < kSortMin ||
      survivors > kSelectMaxKeys || (survivors & (survivors - 1)) != 0 ||
      select_smem != select_smem_bytes(survivors) ||
      reinterpret_cast<size_t>(scores) % 16 != 0) {
    return invalid;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(hist, 0, (size_t)B * kSelectBins * sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_shared_memory(topk_select_score_kernel, score_smem, g_select_score_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid1(n_runs, (B + kTileQueries - 1) / kTileQueries);
  topk_select_score_kernel<<<grid1, kTileItems, score_smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(items),
      static_cast<const int*>(excl), B, N, R, E, n_tiles, T, ld,
      static_cast<float*>(scores), static_cast<unsigned*>(hist));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_shared_memory(topk_select_kernel, select_smem, g_select_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_select_kernel<<<B, kSelectThreads, select_smem, s>>>(
      static_cast<const float*>(scores), static_cast<const unsigned*>(hist), N, ld,
      K, survivors, static_cast<float*>(out_s), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

// cudaFuncGetAttributes of every kernel here, in this order: topk_run_kernel,
// topk_run_tiled_kernel, topk_tile_kernel, topk_merge_kernel,
// topk_merge_round_kernel, topk_store_kernel, topk_select_score_kernel,
// topk_select_kernel; three ints each (registers a thread, local bytes a
// thread, static shared bytes).
extern "C" int pio_topk_streaming_attrs(int* out) {
  const void* kernels[] = {
      reinterpret_cast<const void*>(topk_run_kernel),
      reinterpret_cast<const void*>(topk_run_tiled_kernel),
      reinterpret_cast<const void*>(topk_tile_kernel),
      reinterpret_cast<const void*>(topk_merge_kernel),
      reinterpret_cast<const void*>(topk_merge_round_kernel),
      reinterpret_cast<const void*>(topk_store_kernel),
      reinterpret_cast<const void*>(topk_select_score_kernel),
      reinterpret_cast<const void*>(topk_select_kernel),
  };
  int i = 0;
  for (const void* k : kernels) {
    cudaFuncAttributes at;
    const cudaError_t err = cudaFuncGetAttributes(&at, k);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[i++] = at.numRegs;
    out[i++] = static_cast<int>(at.localSizeBytes);
    out[i++] = static_cast<int>(at.sharedSizeBytes);
  }
  return 0;
}

// Blocks of a running-list kernel (stage1 = kStage1Run or kStage1RunTiled)
// an SM holds at `smem` bytes of dynamic shared memory, set up as a launch
// sets it up (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks.
extern "C" int pio_topk_streaming_occupancy(int stage1, int smem, int* blocks) {
  cudaError_t err;
  if (stage1 == kStage1Run) {
    err = allow_shared_memory(topk_run_kernel, smem, g_run_smem);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, topk_run_kernel,
                                                          kTileItems, smem);
    }
  } else if (stage1 == kStage1RunTiled) {
    err = prepare_run_tiled(smem);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, topk_run_tiled_kernel, kTileItems, smem);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" const char* pio_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
