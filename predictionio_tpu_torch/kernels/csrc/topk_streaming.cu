// Streaming top-k for recommendation serving, hand-written for Hopper (sm_90a).
//
// Replaces predictionio_tpu/ops/pallas_kernels.py::_topk_kernel (the Pallas
// body of top_k_streaming, with its selection helper _select_topk). For each
// query row b it returns the k best (score, item) pairs of q[b] . items[n]
// over the whole catalog, ordered by score descending and, on equal scores,
// by item index ascending. The [B, N] score matrix never reaches device
// memory: scores live in registers and shared memory only.
//
// Contract (the JAX kernel's, checked by tests/test_torch_topk.py against it
// and by chip_smoke.py against the plain PyTorch version on the card):
//   - excl is [B, E] item ids, -1 padded; an excluded item scores -inf;
//   - any slot whose score is -inf carries index -1;
//   - the caller clamps k to N and pads back to the requested k;
//   - any rank R (no padding of R), any N (the ragged last tile is masked).
//
// Design. The TPU kernel walks item tiles in grid order and carries a running
// [B, k] top-k in VMEM from one grid step to the next. Blocks on the card run
// in parallel and in no order, so the selection is split in two launches:
//   Stage 1 (topk_tile_kernel): one block per (8-query tile x 256-item tile).
//     Each thread owns one item; the item tile is staged through shared memory
//     16 ranks at a time (coalesced loads), each thread accumulates 8 fp32 dot
//     products with FMAs in registers (no tensor cores, no library GEMM). The
//     validity and exclusion masks apply, then a bitonic sort in shared memory
//     orders each query's 256 candidates, and the best kt = min(k, 256) go to
//     scratch [B, n_tiles, kt] allocated by the wrapper.
//   Stage 2 (topk_merge_kernel): one block per query merges the n_tiles sorted
//     lists into a running top-k kept in shared memory. Each merge step places
//     every element at its rank in the merged order (its own position plus a
//     binary search in the other list); ranks past k are dropped. All keys of
//     one query are distinct (item indices are unique, and the running list is
//     padded with distinct sentinel indices above every real one), so the
//     ranks form a permutation and the merge is exact.
//
// Ceiling: k <= kMaxK = 2048, set by stage 2's shared memory (4k + 2kt
// floats, 34.8 KB at the ceiling, under the 48 KB a block gets without an
// opt-in). The wrapper raises above it; it never falls back.
//
// Bound at the serving slice's shapes (ML-20M width: N = 27,000 items, R = 50,
// k = 16; H100 SXM data sheet: 3.35 TB/s, fp32 outside the tensor cores about
// 67 TFLOP/s): one batch reads the 5.4 MB item table once (about 1.6 us);
// B = 64 is 0.17 GFLOP (about 2.6 us), B = 1024 is 2.8 GFLOP (about 41 us), so
// large batches are bound by fp32 FMAs. This first version is written to be
// right, not fast: the per-tile bitonic sort and the sequential merge are its
// known costs (measured times in PERF.md). Tensor cores on an exact split,
// TMA staging and an early-exit merge are later work.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTileItems = 256;    // items per stage-1 block, one per thread
constexpr int kTileQueries = 8;    // queries per stage-1 block
constexpr int kRankChunk = 16;     // ranks staged in shared memory per step
constexpr int kMergeThreads = 256;
constexpr int kMaxK = 2048;
// Running-list padding takes indices above every real item index.
constexpr int kSentinelBase = INT_MAX - kMaxK;

// True when (sa, ia) ranks ahead of (sb, ib): higher score, then lower index.
__device__ __forceinline__ bool before(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

__global__ void __launch_bounds__(kTileItems)
topk_tile_kernel(const float* __restrict__ q, const float* __restrict__ items,
                 const int* __restrict__ excl, int B, int N, int R, int E,
                 int kt, int n_tiles, float* __restrict__ cand_s,
                 int* __restrict__ cand_i) {
  __shared__ float s_items[kRankChunk][kTileItems + 1];
  __shared__ float s_q[kTileQueries][kRankChunk];
  __shared__ float s_key[kTileQueries][kTileItems];
  __shared__ int s_idx[kTileQueries][kTileItems];

  const int t = threadIdx.x;
  const int tile = blockIdx.x;
  const int q0 = blockIdx.y * kTileQueries;
  const int item0 = tile * kTileItems;
  const int j = item0 + t;

  float acc[kTileQueries];
#pragma unroll
  for (int qi = 0; qi < kTileQueries; ++qi) acc[qi] = 0.f;

  for (int r0 = 0; r0 < R; r0 += kRankChunk) {
    const int rc = min(kRankChunk, R - r0);
    for (int l = t; l < kTileItems * rc; l += kTileItems) {
      const int it = l / rc;
      const int rr = l - it * rc;
      const int gi = item0 + it;
      s_items[rr][it] = gi < N ? items[(size_t)gi * R + r0 + rr] : 0.f;
    }
    for (int l = t; l < kTileQueries * rc; l += kTileItems) {
      const int qi = l / rc;
      const int rr = l - qi * rc;
      const int gq = q0 + qi;
      s_q[qi][rr] = gq < B ? q[(size_t)gq * R + r0 + rr] : 0.f;
    }
    __syncthreads();
    for (int rr = 0; rr < rc; ++rr) {
      const float x = s_items[rr][t];
#pragma unroll
      for (int qi = 0; qi < kTileQueries; ++qi) {
        acc[qi] = fmaf(s_q[qi][rr], x, acc[qi]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int qi = 0; qi < kTileQueries; ++qi) {
    s_key[qi][t] = (j < N && q0 + qi < B) ? acc[qi] : -CUDART_INF_F;
    s_idx[qi][t] = j;
  }
  __syncthreads();

  if (E > 0) {
    for (int l = t; l < kTileQueries * E; l += kTileItems) {
      const int qi = l / E;
      const int e = l - qi * E;
      const int gq = q0 + qi;
      if (gq < B) {
        const int x = excl[(size_t)gq * E + e];
        if (x >= item0 && x < item0 + kTileItems) {
          s_key[qi][x - item0] = -CUDART_INF_F;
        }
      }
    }
    __syncthreads();
  }

  // Bitonic sort of each query's row, best first.
  for (int size = 2; size <= kTileItems; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int p = t ^ stride;
      if (p > t) {
        const bool best_first = (t & size) == 0;
#pragma unroll
        for (int qi = 0; qi < kTileQueries; ++qi) {
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
      __syncthreads();
    }
  }

  for (int l = t; l < kTileQueries * kt; l += kTileItems) {
    const int qi = l / kt;
    const int m = l - qi * kt;
    const int gq = q0 + qi;
    if (gq < B) {
      const size_t o = ((size_t)gq * n_tiles + tile) * kt + m;
      cand_s[o] = s_key[qi][m];
      cand_i[o] = s_idx[qi][m];
    }
  }
}

__global__ void __launch_bounds__(kMergeThreads)
topk_merge_kernel(const float* __restrict__ cand_s,
                  const int* __restrict__ cand_i, int n_tiles, int kt, int K,
                  float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* run_s = reinterpret_cast<float*>(smem);
  int* run_i = reinterpret_cast<int*>(run_s + K);
  float* nxt_s = reinterpret_cast<float*>(run_i + K);
  int* nxt_i = reinterpret_cast<int*>(nxt_s + K);
  float* til_s = reinterpret_cast<float*>(nxt_i + K);
  int* til_i = reinterpret_cast<int*>(til_s + kt);

  const int t = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * n_tiles * kt;

  for (int m = t; m < K; m += kMergeThreads) {
    if (m < kt) {
      run_s[m] = cand_s[base + m];
      run_i[m] = cand_i[base + m];
    } else {
      run_s[m] = -CUDART_INF_F;
      run_i[m] = kSentinelBase + m;
    }
  }

  for (int tile = 1; tile < n_tiles; ++tile) {
    const size_t off = base + (size_t)tile * kt;
    for (int m = t; m < kt; m += kMergeThreads) {
      til_s[m] = cand_s[off + m];
      til_i[m] = cand_i[off + m];
    }
    __syncthreads();
    for (int m = t; m < K; m += kMergeThreads) {
      const float s = run_s[m];
      const int i = run_i[m];
      int lo = 0, hi = kt;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (before(til_s[mid], til_i[mid], s, i)) lo = mid + 1; else hi = mid;
      }
      const int rank = m + lo;
      if (rank < K) {
        nxt_s[rank] = s;
        nxt_i[rank] = i;
      }
    }
    for (int m = t; m < kt; m += kMergeThreads) {
      const float s = til_s[m];
      const int i = til_i[m];
      int lo = 0, hi = K;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (before(run_s[mid], run_i[mid], s, i)) lo = mid + 1; else hi = mid;
      }
      const int rank = m + lo;
      if (rank < K) {
        nxt_s[rank] = s;
        nxt_i[rank] = i;
      }
    }
    __syncthreads();
    float* fs = run_s; run_s = nxt_s; nxt_s = fs;
    int* fi = run_i; run_i = nxt_i; nxt_i = fi;
  }
  __syncthreads();

  const size_t o = (size_t)blockIdx.x * K;
  for (int m = t; m < K; m += kMergeThreads) {
    const float s = run_s[m];
    out_s[o + m] = s;
    out_i[o + m] = s == -CUDART_INF_F ? -1 : run_i[m];
  }
}

}  // namespace

// Launches both stages on `stream` and returns cudaGetLastError() (0 = ok).
// Pointers are device pointers: q [B, R] f32, items [N, R] f32, excl [B, E]
// i32 (may be null when E == 0), scratch cand_s/cand_i [B, n_tiles, kt],
// outputs out_s/out_i [B, K]. The caller guarantees 1 <= K <= 2048,
// kt = min(K, 256), n_tiles = ceil(N / 256), B >= 1, N >= 1.
extern "C" int pio_topk_streaming(const void* q, const void* items,
                                  const void* excl, int B, int N, int R, int E,
                                  int K, int kt, int n_tiles, void* cand_s,
                                  void* cand_i, void* out_s, void* out_i,
                                  void* stream) {
  if (B < 1 || N < 1 || R < 1 || E < 0 || K < 1 || K > kMaxK || kt < 1 ||
      kt > kTileItems || kt > K ||
      n_tiles != (N + kTileItems - 1) / kTileItems) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid1(n_tiles, (B + kTileQueries - 1) / kTileQueries);
  topk_tile_kernel<<<grid1, kTileItems, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(items),
      static_cast<const int*>(excl), B, N, R, E, kt, n_tiles,
      static_cast<float*>(cand_s), static_cast<int*>(cand_i));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(4 * K + 2 * kt) * sizeof(float);
  topk_merge_kernel<<<B, kMergeThreads, smem, s>>>(
      static_cast<const float*>(cand_s), static_cast<const int*>(cand_i),
      n_tiles, kt, K, static_cast<float*>(out_s), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pio_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
