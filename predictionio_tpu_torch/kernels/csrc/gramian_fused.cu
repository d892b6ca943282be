// Fused gather + Gramian (the ALS normal-equation build), hand-written for
// Hopper (sm_90a).
//
// Replaces predictionio_tpu/ops/pallas_kernels.py::_gramian_kernel (the Pallas
// body of gramian_fused). For each solve row b it builds
//   A_b = yty + ridge_b * I + sum_k w2[b,k] * y[idx[b,k]] (x) y[idx[b,k]]
//   b_b = sum_k rhs[b,k] * y[idx[b,k]]
// without a [B, K, R] gathered intermediate in device memory: the gathered
// factor rows live in shared memory only.
//
// Contract (the JAX kernel's, checked by tests/test_torch_als_kernels.py
// against it and by chip_smoke.py against the plain PyTorch version on the
// card):
//   - any R >= 1, unpadded (the TPU kernel's R % 8 rule and its 128-lane row
//     padding were Mosaic DMA limits), any K: R up to kMaxR = 128 takes the
//     tuned path below, wider R the general-rank path (picked by R alone);
//   - a slot with w2 = rhs = 0 contributes nothing and its factor row (and
//     index) is not read; an index outside [0, N) reads as a zero row;
//   - yty may be null (explicit mode); a row whose weights, ridge and yty are
//     all zero gives an exactly-zero system;
//   - each row's sums start at zero in its own blocks, and a row's chunk
//     partials are added only into that row, so an Inf or NaN in one row
//     cannot reach another (the TPU kernel's select-not-multiply reset
//     guards the same thing);
//   - A is written exactly symmetric (both triangles from one sum), and no
//     atomics are used: two calls on the same inputs give the same bits.
// The wrapper upcasts a bf16 table to f32 before the launch.
//
// Design. The TPU kernel streams a block of rows through a sequential grid
// with a double-buffered DMA per rating; on the card rows are independent.
// The launch plan (ops/cuda_kernels.py::gramian_launch_plan, checked by the
// entry point) cuts each row's K slots into S chunks of kc, one block per
// (row, chunk). While the rows alone fill the card (at the training
// slice's shapes every bucket up to K = 2,048) S = 1 and the block writes
// its row's system. The wide buckets, a few hundred rows of up to 32,768
// slots, are split: each chunk block writes its partial system to a
// [B, S, P] scratch and a reduce kernel adds a row's partials in chunk
// order, then yty and ridge * I. (One block a row left 216 blocks for the
// widest bucket on 132 SMs, each walking 1,024 tiles one after another.)
//
// A block first finds its chunk's last slot with a weight (the ALS buckets
// pad each row at its tail; 44-57 % of the slots of most buckets carry
// weight) and walks only up to it, in tiles of kKTile: a tile ends at its
// last live slot (a warp vote), and one with none is skipped. Per tile it
// stages the slots' weights and indices, then gathers the live slots'
// factor rows into shared memory twice: y as the left operand (pitch
// RP = 4T) and w2 * y as the right one with rhs in column R (pitch
// CP = 4TC, TC = ceil((R + 1) / 4)), so b is column R of the same product
// as A. Each thread owns one 4x4 block of [A | b] (91 at R = 50) and keeps
// its 16 sums in registers: per rating two 16-byte shared loads feed 16
// fp32 FMAs on the CUDA cores (no tensor cores, so no TF32). Each tile is
// summed from zero and then added to the chunk's total, so the rounding
// grows with the tiles, not with K: with one running sum per entry, 3
// training iterations drifted up to 8.3e-4 from the plain version's
// factors; summed by tiles, 2.5e-4 (chip_smoke.py on an H100 80GB HBM3 at
// 700 W). The finished system (or partial) is staged in shared memory and
// written whole, neighbouring threads on neighbouring addresses (A in
// 16-byte stores where R * R is a multiple of 4).
//
// General-rank path (R > kMaxR). A thread block of the tuned path holds one
// thread per 4x4 block of [A | b], which passes the 576 threads a block may
// have above R = 128. Here [A | b]'s upper triangle is cut into square
// output tiles of kWTile = 64 (tile (ti, tj), tj >= ti, with b in the tile
// column that holds column R), and one block of kWThreads = 256 threads (16 x
// 16, a 4x4 block each) takes one (row, tile, chunk). Per step of kKTile
// ratings it stages only the two 64-wide column slices of the gathered rows
// that its tile needs (the left one y, the right one w2 * y | rhs), so its
// shared memory does not grow with R. Each entry is summed as on the tuned
// path: the same fmaf per rating, each kKTile tile from zero and then into
// the chunk's total, the same chunks of kc (the plan's S from the same
// rule, with tiles x rows blocks in place of rows), the chunk partials added
// in chunk order by a reduce that reads them from device memory (a row's
// partial system passes shared memory above R = 234), and no atomics. A
// tile is written through shared memory in two passes, its rows and then
// its mirrored rows, so both triangles come from one sum. It is the simple
// first version: each tile reads its weights and gathers its rows again,
// and a thread still issues two shared loads per 16 FMAs.
//
// Bound at the training slice's shapes (ML-20M width, R = 50, 19.0M training
// ratings, fewer per side after rows are truncated at 32,768; H100 SXM data
// sheet: 3.35 TB/s, about 67 TFLOP/s fp32 outside the tensor cores): the
// symmetric build needs R(R+1) + 2R = 2,650 FLOP per rating; the bytes it
// must move are the factor table once, 12 B of idx/w2/rhs per padded slot and
// the [B, R, R] systems once. chip_smoke.py computes the bound of each launch
// from its inputs: 1.46 ms for one iteration's 11 launches, 1.03 ms of it
// bound by operations (widths 512 and up) and 0.43 ms by bytes (widths 32 and
// 128, where writing the systems dominates). This version takes 8.5 ms an
// iteration there (chip_smoke.py, H100 80GB HBM3 at 700 W), 5.8x the bound:
// each tile still waits on two dependent global round trips (weights, then
// the rows they index) between barriers, and a thread issues two shared
// loads per 16 FMAs. Loading the next tile's rows into registers during the
// FMAs took 167 registers and a third of the resident blocks, and into a
// second shared buffer by cp.async gained on one-pass buckets what it lost
// on split ones; both were measured and dropped.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTile = 4;     // each thread owns a kTile x kTile block
constexpr int kKTile = 32;   // ratings staged in shared memory per step
constexpr int kMaxR = 128;
constexpr int kMinChunk = 256;  // the narrowest chunk of a split row
constexpr int kMaxThreads = 576;
// the general-rank path (R > kMaxR)
constexpr int kWTile = 64;      // side of an output tile of [A | b]
constexpr int kWThreads = 256;  // 16 x 16 threads, a kTile x kTile block each
constexpr int kWMinBlocks = 4;  // launch bound: at most 64 registers a thread
constexpr int kWMaxR = 46340;   // R * R stays an int

// Index of (i, j), i <= j < R, in a row-major packed upper triangle.
__device__ __forceinline__ int tri_index(int i, int j, int R) {
  return i * R - i * (i - 1) / 2 + (j - i);
}

// Pass 1: one block per (row, chunk). The left operand of the product is
// the gathered rows y (pitch RP = 4T), the right one w2 * y with rhs in
// column R (pitch CP = 4TC, TC = ceil((R + 1) / 4)), so column R of the
// product is b: A and b come out of one loop of 4x4 blocks. With kDirect
// (one chunk per row) the block adds yty and ridge * I and writes the
// row's system; otherwise it writes the chunk's partial [R(R+1)/2 upper
// triangle | R of b] to part. Either is staged in shared memory first and
// written with neighbouring threads on neighbouring addresses.
template <bool kDirect>
__global__ void __launch_bounds__(kMaxThreads)
gramian_chunk_kernel(const float* __restrict__ y, const int* __restrict__ idx,
                     const float* __restrict__ w2,
                     const float* __restrict__ rhs,
                     const float* __restrict__ ridge,
                     const float* __restrict__ yty, int K, int N, int R, int T,
                     int TC, int kc, int S, float* __restrict__ a_out,
                     float* __restrict__ b_out, float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  const int RP = T * kTile;
  const int CP = TC * kTile;
  float* s_g = smem;                      // [kKTile][RP] gathered rows
  float* s_gw = s_g + kKTile * RP;        // [kKTile][CP] w2 * rows | rhs
  float* s_w = s_gw + kKTile * CP;        // [2][kKTile] w2, by tile parity
  float* s_r = s_w + 2 * kKTile;          // [2][kKTile] rhs
  int* s_i = reinterpret_cast<int*>(s_r + 2 * kKTile);  // [2][kKTile] row
  int* s_n = s_i + 2 * kKTile;            // [2] live slots; [2] chunk end

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const size_t row = blockIdx.x / S;
  const int chunk = static_cast<int>(blockIdx.x - row * S);
  const size_t base = row * K;
  const int c0 = chunk * kc;
  const int c1 = min(K, c0 + kc);

  // the chunk ends at its last slot with a weight: trailing padding (the
  // ALS buckets pad each row at its tail) is neither staged nor multiplied
  if (tid == 0) s_n[2] = -1;
  __syncthreads();
  int last = -1;
  for (int k = c0 + tid; k < c1; k += nthreads) {
    if (w2[base + k] != 0.f || rhs[base + k] != 0.f) last = k;
  }
  last = __reduce_max_sync(0xffffffffu, last);
  if ((tid & 31) == 0 && last >= 0) atomicMax(s_n + 2, last);
  __syncthreads();
  const int kend = s_n[2] + 1;

  // this thread's block (bi, bj) of the product: bi <= bj < T (A's upper
  // triangle), then (bi, T) when column R needs a block of its own
  const int n_upper = T * (T + 1) / 2;
  int bi = -1, bj = -1;
  if (tid < n_upper) {
    int rem = tid;
    bi = 0;
    while (rem >= T - bi) {
      rem -= T - bi;
      ++bi;
    }
    bj = bi + rem;
  } else if (TC > T && tid < n_upper + T) {
    bi = tid - n_upper;
    bj = T;
  }

  // warp 0 stages a tile's weights and indices into slot `buf` and the
  // tile's live length: up to its last slot with a weight (0: none)
  auto stage = [&](int k0, int buf) {
    if (tid < kKTile) {
      const int kt = min(kKTile, kend - k0);
      float w = 0.f, r = 0.f;
      int j = -1;
      if (tid < kt) {
        w = w2[base + k0 + tid];
        r = rhs[base + k0 + tid];
        if (w != 0.f || r != 0.f) {
          j = idx[base + k0 + tid];
          if (j < 0 || j >= N) j = -1;
        }
      }
      s_w[buf * kKTile + tid] = w;
      s_r[buf * kKTile + tid] = r;
      s_i[buf * kKTile + tid] = j;
      const unsigned live = __ballot_sync(0xffffffffu, w != 0.f || r != 0.f);
      if (tid == 0) s_n[buf] = 32 - __clz(live);
    }
  };

  // a thread's elements of a tile's [kKTile][CP] right operand, e = tid,
  // tid + nthreads, ..., walked as (row kk, column c) without a division
  const int dk = nthreads / CP;
  const int dc = nthreads - dk * CP;
  const int kk0 = tid / CP;
  const int cc0 = tid - kk0 * CP;

  float acc[kTile][kTile];
#pragma unroll
  for (int ii = 0; ii < kTile; ++ii) {
#pragma unroll
    for (int jj = 0; jj < kTile; ++jj) acc[ii][jj] = 0.f;
  }

  int buf = 0;
  for (int k0 = c0; k0 < kend; k0 += kKTile, buf ^= 1) {
    stage(k0, buf);
    __syncthreads();
    const int n = s_n[buf];  // the next tile stages into the other slot
    if (n == 0) continue;
    // gather the live slots' rows: y on the left, w2 * y | rhs on the right
    for (int kk = kk0, c = cc0; kk < n;) {
      float g = 0.f;
      const int j = s_i[buf * kKTile + kk];
      if (j >= 0 && c < R) g = y[static_cast<size_t>(j) * R + c];
      if (c < RP) s_g[kk * RP + c] = g;
      s_gw[kk * CP + c] =
          c == R ? s_r[buf * kKTile + kk] : s_w[buf * kKTile + kk] * g;
      kk += dk;
      c += dc;
      if (c >= CP) {
        c -= CP;
        ++kk;
      }
    }
    __syncthreads();
    // two-level sums: each tile is summed from zero, then added to the
    // chunk's total, so rounding grows with kKTile + kc / kKTile terms
    // rather than with K (K reaches 32,768)
    if (bi >= 0) {
      float tpart[kTile][kTile];
#pragma unroll
      for (int ii = 0; ii < kTile; ++ii) {
#pragma unroll
        for (int jj = 0; jj < kTile; ++jj) tpart[ii][jj] = 0.f;
      }
      for (int kk = 0; kk < n; ++kk) {
        const float4 p =
            *reinterpret_cast<const float4*>(s_g + kk * RP + bi * kTile);
        const float4 q =
            *reinterpret_cast<const float4*>(s_gw + kk * CP + bj * kTile);
        const float pv[kTile] = {p.x, p.y, p.z, p.w};
        const float qv[kTile] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int ii = 0; ii < kTile; ++ii) {
#pragma unroll
          for (int jj = 0; jj < kTile; ++jj) {
            tpart[ii][jj] = fmaf(pv[ii], qv[jj], tpart[ii][jj]);
          }
        }
      }
#pragma unroll
      for (int ii = 0; ii < kTile; ++ii) {
#pragma unroll
        for (int jj = 0; jj < kTile; ++jj) acc[ii][jj] += tpart[ii][jj];
      }
    }
    __syncthreads();
  }

  // stage the result in shared memory (the tiles are no longer read)
  if (kDirect) {
    float* s_a = smem;          // [R][R]
    float* s_b = smem + R * R;  // [R]
    const float rdg = ridge[row];
    if (bi >= 0) {
#pragma unroll
      for (int ii = 0; ii < kTile; ++ii) {
#pragma unroll
        for (int jj = 0; jj < kTile; ++jj) {
          const int i = bi * kTile + ii;
          const int j = bj * kTile + jj;
          if (i < R && j < R && i <= j) {
            float v = acc[ii][jj];
            if (yty != nullptr) v += yty[i * R + j];
            if (i == j) v += rdg;
            s_a[i * R + j] = v;  // both triangles from one sum
            s_a[j * R + i] = v;
          } else if (i < R && j == R) {
            s_b[i] = acc[ii][jj];
          }
        }
      }
    }
    __syncthreads();
    float* a_row = a_out + row * R * R;
    const int nn = R * R;
    if ((nn & 3) == 0 && (reinterpret_cast<uintptr_t>(a_out) & 15) == 0) {
      const float4* src = reinterpret_cast<const float4*>(s_a);
      float4* dst = reinterpret_cast<float4*>(a_row);
      for (int e = tid; e < nn / 4; e += nthreads) dst[e] = src[e];
    } else {
      for (int e = tid; e < nn; e += nthreads) a_row[e] = s_a[e];
    }
    for (int i = tid; i < R; i += nthreads) b_out[row * R + i] = s_b[i];
  } else {
    const int tri = R * (R + 1) / 2;
    const int P = tri + R;
    float* s_p = smem;  // [P]
    if (bi >= 0) {
#pragma unroll
      for (int ii = 0; ii < kTile; ++ii) {
#pragma unroll
        for (int jj = 0; jj < kTile; ++jj) {
          const int i = bi * kTile + ii;
          const int j = bj * kTile + jj;
          if (i < R && j < R && i <= j) {
            s_p[tri_index(i, j, R)] = acc[ii][jj];
          } else if (i < R && j == R) {
            s_p[tri + i] = acc[ii][jj];
          }
        }
      }
    }
    __syncthreads();
    // a chunk with no weights still writes its zeros: the reduce reads all
    float* p_out = part + (row * S + chunk) * static_cast<size_t>(P);
    for (int e = tid; e < P; e += nthreads) p_out[e] = s_p[e];
  }
}

// Pass 2: one block per row. Adds the row's S chunk partials in chunk order
// 0..S-1 (no atomics: two calls give the same bits), then yty and ridge * I
// once, and writes both triangles of A and b with neighbouring threads on
// neighbouring addresses.
__global__ void gramian_reduce_kernel(const float* __restrict__ part,
                                      const float* __restrict__ ridge,
                                      const float* __restrict__ yty, int R,
                                      int S, float* __restrict__ a_out,
                                      float* __restrict__ b_out) {
  extern __shared__ float s_sum[];  // [P]
  const int tri = R * (R + 1) / 2;
  const int P = tri + R;
  const size_t row = blockIdx.x;
  const float* p_row = part + row * S * static_cast<size_t>(P);
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < S; ++s) v += p_row[static_cast<size_t>(s) * P + p];
    s_sum[p] = v;
  }
  __syncthreads();
  const float rdg = ridge[row];
  float* a_row = a_out + row * R * R;
  for (int e = threadIdx.x; e < R * R; e += blockDim.x) {
    const int r0 = e / R;
    const int c0 = e - r0 * R;
    const int i = min(r0, c0);
    const int j = max(r0, c0);
    float v = s_sum[tri_index(i, j, R)];
    if (yty != nullptr) v += yty[i * R + j];
    if (i == j) v += rdg;
    a_row[e] = v;
  }
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    b_out[row * R + i] = s_sum[tri + i];
  }
}

// ---- the general-rank path (R > kMaxR) --------------------------------------
// Tile t of the upper triangle of [A | b] as (ti, tj), tj >= ti, in row-major
// order over TCW = ceil((R + 1) / kWTile) tile columns.
__device__ __forceinline__ void wide_tile(int t, int TCW, int* ti, int* tj) {
  int i = 0;
  while (t >= TCW - i) {
    t -= TCW - i;
    ++i;
  }
  *ti = i;
  *tj = i + t;
}

// Pass 1 of the general-rank path: one block per (row, tile, chunk), block
// index (row * n_tiles + tile) * S + chunk. Entry (i, j) of the tile is the
// same sum as on the tuned path. With kDirect (S = 1) the block adds yty and
// ridge * I and writes its tile of A (and of b); otherwise it writes its
// entries of the chunk's partial [R(R+1)/2 upper triangle | R of b] to part.
template <bool kDirect>
__global__ void __launch_bounds__(kWThreads, kWMinBlocks)
gramian_wide_kernel(const float* __restrict__ y, const int* __restrict__ idx,
                    const float* __restrict__ w2,
                    const float* __restrict__ rhs,
                    const float* __restrict__ ridge,
                    const float* __restrict__ yty, int K, int N, int R,
                    int TCW, int n_tiles, int kc, int S,
                    float* __restrict__ a_out, float* __restrict__ b_out,
                    float* __restrict__ part) {
  __shared__ __align__(16) float s_g[kKTile][kWTile];   // y[:, i0 .. i0 + 64)
  __shared__ __align__(16) float s_gw[kKTile][kWTile];  // w2 * y | rhs
  __shared__ float s_o[kWTile][kWTile + 1];              // the finished tile
  __shared__ float s_w[2][kKTile];
  __shared__ float s_r[2][kKTile];
  __shared__ int s_i[2][kKTile];
  __shared__ int s_n[3];  // [2] live slots by tile parity; [2] chunk end

  const int tid = threadIdx.x;
  const int tx = tid % (kWTile / kTile);  // this thread's block (ty, tx)
  const int ty = tid / (kWTile / kTile);
  size_t blk = blockIdx.x;
  const int chunk = static_cast<int>(blk % S);
  blk /= S;
  const int tile = static_cast<int>(blk % n_tiles);
  const size_t row = blk / n_tiles;
  int ti, tj;
  wide_tile(tile, TCW, &ti, &tj);
  const int i0 = ti * kWTile, j0 = tj * kWTile;
  const size_t base = row * K;
  const int c0 = chunk * kc;
  const int c1 = min(K, c0 + kc);

  // the chunk ends at its last slot with a weight, as on the tuned path
  if (tid == 0) s_n[2] = -1;
  __syncthreads();
  int last = -1;
  for (int k = c0 + tid; k < c1; k += kWThreads) {
    if (w2[base + k] != 0.f || rhs[base + k] != 0.f) last = k;
  }
  last = __reduce_max_sync(0xffffffffu, last);
  if ((tid & 31) == 0 && last >= 0) atomicMax(s_n + 2, last);
  __syncthreads();
  const int kend = s_n[2] + 1;

  // the block holds an entry the output needs (i < R, i <= j <= R)
  const int bi = i0 + ty * kTile, bj = j0 + tx * kTile;
  const bool active = bi < R && bj <= R && bj + kTile - 1 >= bi;

  float acc[kTile][kTile];
#pragma unroll
  for (int ii = 0; ii < kTile; ++ii) {
#pragma unroll
    for (int jj = 0; jj < kTile; ++jj) acc[ii][jj] = 0.f;
  }

  int buf = 0;
  for (int k0 = c0; k0 < kend; k0 += kKTile, buf ^= 1) {
    if (tid < kKTile) {  // warp 0 stages the tile's weights and indices
      const int kt = min(kKTile, kend - k0);
      float w = 0.f, r = 0.f;
      int j = -1;
      if (tid < kt) {
        w = w2[base + k0 + tid];
        r = rhs[base + k0 + tid];
        if (w != 0.f || r != 0.f) {
          j = idx[base + k0 + tid];
          if (j < 0 || j >= N) j = -1;
        }
      }
      s_w[buf][tid] = w;
      s_r[buf][tid] = r;
      s_i[buf][tid] = j;
      const unsigned live = __ballot_sync(0xffffffffu, w != 0.f || r != 0.f);
      if (tid == 0) s_n[buf] = 32 - __clz(live);
    }
    __syncthreads();
    const int n = s_n[buf];
    if (n == 0) continue;
    for (int e = tid; e < n * kWTile; e += kWThreads) {
      const int kk = e / kWTile, c = e - kk * kWTile;
      const int j = s_i[buf][kk];
      const float* yr = y + static_cast<size_t>(j >= 0 ? j : 0) * R;
      s_g[kk][c] = j >= 0 && i0 + c < R ? yr[i0 + c] : 0.f;
      const int col = j0 + c;
      float g = j >= 0 && col < R ? yr[col] : 0.f;
      s_gw[kk][c] = col == R ? s_r[buf][kk] : s_w[buf][kk] * g;
    }
    __syncthreads();
    if (active) {
      float tpart[kTile][kTile];
#pragma unroll
      for (int ii = 0; ii < kTile; ++ii) {
#pragma unroll
        for (int jj = 0; jj < kTile; ++jj) tpart[ii][jj] = 0.f;
      }
      for (int kk = 0; kk < n; ++kk) {
        const float4 p = *reinterpret_cast<const float4*>(&s_g[kk][ty * kTile]);
        const float4 q = *reinterpret_cast<const float4*>(&s_gw[kk][tx * kTile]);
        const float pv[kTile] = {p.x, p.y, p.z, p.w};
        const float qv[kTile] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int ii = 0; ii < kTile; ++ii) {
#pragma unroll
          for (int jj = 0; jj < kTile; ++jj) {
            tpart[ii][jj] = fmaf(pv[ii], qv[jj], tpart[ii][jj]);
          }
        }
      }
#pragma unroll
      for (int ii = 0; ii < kTile; ++ii) {
#pragma unroll
        for (int jj = 0; jj < kTile; ++jj) acc[ii][jj] += tpart[ii][jj];
      }
    }
    __syncthreads();
  }

  if (active) {
#pragma unroll
    for (int ii = 0; ii < kTile; ++ii) {
#pragma unroll
      for (int jj = 0; jj < kTile; ++jj) {
        s_o[ty * kTile + ii][tx * kTile + jj] = acc[ii][jj];
      }
    }
  }
  __syncthreads();
  constexpr int kTileEntries = kWTile * kWTile;
  if (kDirect) {
    const float rdg = ridge[row];
    float* a_row = a_out + row * static_cast<size_t>(R) * R;
    // the tile's rows (neighbouring threads on neighbouring columns), then
    // its mirror below the diagonal (neighbouring threads on neighbouring
    // rows): both triangles from one sum
    for (int e = tid; e < kTileEntries; e += kWThreads) {
      const int r = e / kWTile, c = e - r * kWTile;
      const int i = i0 + r, j = j0 + c;
      if (i < R && j < R && i <= j) {
        float v = s_o[r][c];
        if (yty != nullptr) v += yty[static_cast<size_t>(i) * R + j];
        if (i == j) v += rdg;
        a_row[static_cast<size_t>(i) * R + j] = v;
      } else if (i < R && j == R) {
        b_out[row * R + i] = s_o[r][c];
      }
    }
    for (int e = tid; e < kTileEntries; e += kWThreads) {
      const int c = e / kWTile, r = e - c * kWTile;
      const int i = i0 + r, j = j0 + c;
      if (j < R && i < j) {
        float v = s_o[r][c];
        if (yty != nullptr) v += yty[static_cast<size_t>(i) * R + j];
        a_row[static_cast<size_t>(j) * R + i] = v;
      }
    }
  } else {
    const int tri = R * (R + 1) / 2;
    const size_t P = static_cast<size_t>(tri) + R;
    float* p_out = part + (row * S + chunk) * P;
    // a chunk with no weights still writes its zeros: the reduce reads all
    for (int e = tid; e < kTileEntries; e += kWThreads) {
      const int r = e / kWTile, c = e - r * kWTile;
      const int i = i0 + r, j = j0 + c;
      if (i < R && j < R && i <= j) {
        p_out[tri_index(i, j, R)] = s_o[r][c];
      } else if (i < R && j == R) {
        p_out[tri + i] = s_o[r][c];
      }
    }
  }
}

// Pass 2 of the general-rank path: one block per row; gramian_reduce_kernel's
// sums (a row's S partials in chunk order from zero, then yty, then ridge * I
// on the diagonal), read from device memory instead of shared memory. Both
// triangles of an entry are the same sum, so A is exactly symmetric.
__global__ void gramian_wide_reduce_kernel(const float* __restrict__ part,
                                           const float* __restrict__ ridge,
                                           const float* __restrict__ yty,
                                           int R, int S,
                                           float* __restrict__ a_out,
                                           float* __restrict__ b_out) {
  const int tri = R * (R + 1) / 2;
  const size_t P = static_cast<size_t>(tri) + R;
  const size_t row = blockIdx.x;
  const float* p_row = part + row * S * P;
  const float rdg = ridge[row];
  float* a_row = a_out + row * static_cast<size_t>(R) * R;
  const size_t nn = static_cast<size_t>(R) * R;
  for (size_t e = threadIdx.x; e < nn; e += blockDim.x) {
    const int r0 = static_cast<int>(e / R);
    const int c0 = static_cast<int>(e - static_cast<size_t>(r0) * R);
    const int i = min(r0, c0);
    const int j = max(r0, c0);
    const size_t p = tri_index(i, j, R);
    float v = 0.f;
    for (int s = 0; s < S; ++s) v += p_row[static_cast<size_t>(s) * P + p];
    if (yty != nullptr) v += yty[static_cast<size_t>(i) * R + j];
    if (i == j) v += rdg;
    a_row[e] = v;
  }
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < S; ++s) v += p_row[static_cast<size_t>(s) * P + tri + i];
    b_out[row * R + i] = v;
  }
}

// The general-rank path's launches (see pio_gramian_fused).
int launch_wide(const float* y, const int* idx, const float* w2,
                const float* rhs, const float* ridge, const float* yty, int B,
                int K, int N, int R, int kc, int S, int threads,
                int chunk_smem, int reduce_threads, int reduce_smem,
                float* part, float* a, float* b, cudaStream_t st) {
  const int TR = (R + kWTile - 1) / kWTile;
  const int TCW = (R + kWTile) / kWTile;  // ceil((R + 1) / kWTile)
  const int n_tiles = TR * TCW - TR * (TR - 1) / 2;
  const bool split = S > 1;
  const bool plan_ok =
      R <= kWMaxR && kc >= kKTile && kc % kKTile == 0 && S >= 1 &&
      S == (K > 0 ? (K + kc - 1) / kc : 1) && (!split || kc >= kMinChunk) &&
      threads == kWThreads && chunk_smem == 0 && reduce_smem == 0 &&
      static_cast<long long>(B) * n_tiles * S <= 0x7fffffffLL &&
      (split ? (part != nullptr && reduce_threads > 0 &&
                reduce_threads % 32 == 0 && reduce_threads <= 1024)
             : part == nullptr);
  if (!plan_ok) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(B) * n_tiles * S);
  if (!split) {
    gramian_wide_kernel<true><<<blocks, kWThreads, 0, st>>>(
        y, idx, w2, rhs, ridge, yty, K, N, R, TCW, n_tiles, kc, 1, a, b,
        nullptr);
    return static_cast<int>(cudaGetLastError());
  }
  gramian_wide_kernel<false><<<blocks, kWThreads, 0, st>>>(
      y, idx, w2, rhs, ridge, yty, K, N, R, TCW, n_tiles, kc, S, nullptr,
      nullptr, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gramian_wide_reduce_kernel<<<B, reduce_threads, 0, st>>>(part, ridge, yty, R,
                                                           S, a, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the build on `stream` and returns cudaGetLastError() (0 = ok).
// Device pointers: y [N, R] f32, idx [B, K] i32, w2/rhs [B, K] f32, ridge [B]
// f32, yty [R, R] f32 or null; outputs a [B, R, R] and b [B, R] f32; part
// [B, S, R(R+1)/2 + R] f32 scratch when S > 1, else null. The launch plan
// (chunk width kc, chunks per row S, threads, the chunk and reduce blocks'
// shared memory) is gramian_launch_plan's in ops/cuda_kernels.py for R up to
// kMaxR, and gramian_wide_launch_plan's (the general-rank path: kWThreads
// threads, no dynamic shared memory) above it; a plan that does not match
// this arithmetic is refused (cudaErrorInvalidValue).
extern "C" int pio_gramian_fused(const void* y, const void* idx, const void* w2,
                                 const void* rhs, const void* ridge,
                                 const void* yty, int B, int K, int N, int R,
                                 int kc, int S, int threads, int chunk_smem,
                                 int reduce_threads, int reduce_smem,
                                 void* part, void* a, void* b, void* stream) {
  if (B < 1 || K < 0 || N < 1 || R < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R > kMaxR) {
    return launch_wide(
        static_cast<const float*>(y), static_cast<const int*>(idx),
        static_cast<const float*>(w2), static_cast<const float*>(rhs),
        static_cast<const float*>(ridge), static_cast<const float*>(yty), B, K,
        N, R, kc, S, threads, chunk_smem, reduce_threads, reduce_smem,
        static_cast<float*>(part), static_cast<float*>(a),
        static_cast<float*>(b), static_cast<cudaStream_t>(stream));
  }
  const int T = (R + kTile - 1) / kTile;
  const int TC = (R + kTile) / kTile;  // ceil((R + 1) / kTile)
  const int RP = T * kTile, CP = TC * kTile;
  const int blocks = T * (T + 1) / 2 + (TC > T ? T : 0);
  const int P = R * (R + 1) / 2 + R;
  const bool split = S > 1;
  const int tiles = kKTile * (RP + CP) + 6 * kKTile + 4;
  const int out = split ? P : R * R + R;
  const int smem = (tiles > out ? tiles : out) * static_cast<int>(sizeof(float));
  const bool plan_ok =
      kc >= kKTile && kc % kKTile == 0 && S >= 1 &&
      S == (K > 0 ? (K + kc - 1) / kc : 1) && (!split || kc >= kMinChunk) &&
      threads == (blocks + 31) / 32 * 32 && threads <= kMaxThreads &&
      chunk_smem == smem && static_cast<long long>(B) * S <= 0x7fffffffLL &&
      (split ? (part != nullptr && reduce_threads > 0 &&
                reduce_threads % 32 == 0 && reduce_threads <= 1024 &&
                reduce_smem == P * static_cast<int>(sizeof(float)))
             : (part == nullptr && reduce_smem == 0));
  if (!plan_ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* yf = static_cast<const float*>(y);
  const int* ix = static_cast<const int*>(idx);
  const float* w = static_cast<const float*>(w2);
  const float* rh = static_cast<const float*>(rhs);
  const float* rd = static_cast<const float*>(ridge);
  const float* yt = static_cast<const float*>(yty);
  float* ao = static_cast<float*>(a);
  float* bo = static_cast<float*>(b);
  float* po = static_cast<float*>(part);
  cudaError_t err;
  if (!split) {
    // the staged [R, R] system passes 48 KB above R = 104
    err = cudaFuncSetAttribute(gramian_chunk_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               chunk_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    gramian_chunk_kernel<true><<<B, threads, chunk_smem, st>>>(
        yf, ix, w, rh, rd, yt, K, N, R, T, TC, kc, 1, ao, bo, nullptr);
    return static_cast<int>(cudaGetLastError());
  }
  gramian_chunk_kernel<false><<<B * S, threads, chunk_smem, st>>>(
      yf, ix, w, rh, rd, yt, K, N, R, T, TC, kc, S, nullptr, nullptr, po);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gramian_reduce_kernel<<<B, reduce_threads, reduce_smem, st>>>(po, rd, yt, R,
                                                                 S, ao, bo);
  return static_cast<int>(cudaGetLastError());
}

// The chunk kernels' registers per thread, local (spilled) bytes and static
// shared memory: out[0..2] one pass, out[3..5] split, out[6..8] and
// out[9..11] the general-rank path's one pass and split. Returns the first
// error of cudaFuncGetAttributes.
extern "C" int pio_gramian_fused_attrs(int* out) {
  const void* kernels[] = {
      reinterpret_cast<const void*>(gramian_chunk_kernel<true>),
      reinterpret_cast<const void*>(gramian_chunk_kernel<false>),
      reinterpret_cast<const void*>(gramian_wide_kernel<true>),
      reinterpret_cast<const void*>(gramian_wide_kernel<false>),
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

extern "C" const char* pio_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
