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
//   - any R from 1 to kMaxR = 128, unpadded (the TPU kernel's R % 8 rule and
//     its 128-lane row padding were Mosaic DMA limits), any K with no split;
//   - a slot with w2 = rhs = 0 contributes nothing and its factor row is not
//     read; an index outside [0, N) reads as a zero row, never out of bounds;
//   - yty may be null (explicit mode); a row whose weights, ridge and yty are
//     all zero gives an exactly-zero system;
//   - each row's sums start at zero in that row's own registers, so an Inf or
//     NaN in one row cannot reach another (the TPU kernel's select-not-multiply
//     reset guards the same thing);
//   - A is written exactly symmetric: both triangles from one sum.
// The wrapper upcasts a bf16 table to f32 before the launch.
//
// Design. One block per solve row. The TPU kernel streams a block of rows
// through a sequential grid with a double-buffered DMA per rating; on the card
// rows are independent, so each block walks its row's K ratings in tiles of
// kKTile: it stages the tile's slot weights and indices, then the tile's
// factor rows (neighbouring threads on neighbouring floats of a row) and
// their w2-weighted copies into shared memory. Each thread owns one 4x4 block
// of A's upper triangle (91 blocks at R = 50, 528 at R = 128) and keeps its 16
// sums in registers: per rating two 16-byte shared loads feed 16 fp32 FMAs on
// the CUDA cores (no tensor cores, so no TF32). Thread t < R also sums b[t].
// Each K-tile is summed from zero and then added to the row's total, so the
// rounding grows with K / kKTile terms, not K (up to 32,768): with one
// running sum per entry, 3 training iterations through the kernels drifted up
// to 8.3e-4 from the plain version's (blocked GEMM) factors; summed by tiles,
// 2.5e-4 (chip_smoke.py on an H100 80GB HBM3 at 700 W).
// The block then adds yty and ridge * I once and writes both triangles.
//
// Bound at the training slice's shapes (ML-20M width, R = 50, 19.0M training
// ratings, fewer per side after rows are truncated at 32,768; H100 SXM data
// sheet: 3.35 TB/s, about 67 TFLOP/s fp32 outside the tensor cores): the
// symmetric build needs R(R+1) + 2R = 2,650 FLOP per rating; the bytes it
// must move are the factor table once, 12 B of idx/w2/rhs per padded slot and
// the [B, R, R] systems once. chip_smoke.py computes the bound of each launch
// from its inputs: 1.46 ms for one iteration's 11 launches, 1.03 ms of it
// bound by operations (widths 512 and up) and 0.43 ms by bytes (widths 32 and
// 128, where writing the systems dominates). This first version is written to
// be right, not fast: one block per row leaves the widest buckets (a few
// hundred rows of 8,193-32,768 ratings) with few blocks, padding slots still
// cost FMAs, and the staging is not overlapped with the FMAs. Splitting wide
// rows across blocks, a TF32-exact tensor-core split and TMA staging are
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 4;     // each thread owns a kTile x kTile block of A
constexpr int kKTile = 32;   // ratings staged in shared memory per step
constexpr int kMaxR = 128;

__global__ void gramian_kernel(const float* __restrict__ y,
                               const int* __restrict__ idx,
                               const float* __restrict__ w2,
                               const float* __restrict__ rhs,
                               const float* __restrict__ ridge,
                               const float* __restrict__ yty, int K, int N,
                               int R, int T, float* __restrict__ a_out,
                               float* __restrict__ b_out) {
  // RP = T * kTile: the row pitch in shared memory; columns R..RP-1 hold zeros
  extern __shared__ __align__(16) float smem[];
  const int RP = T * kTile;
  float* s_g = smem;                    // [kKTile][RP] gathered rows
  float* s_gw = s_g + kKTile * RP;      // [kKTile][RP] w2-weighted rows
  float* s_w = s_gw + kKTile * RP;      // [kKTile] w2
  float* s_r = s_w + kKTile;            // [kKTile] rhs
  int* s_i = reinterpret_cast<int*>(s_r + kKTile);  // [kKTile] row or -1

  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * K;

  // this thread's block (bi, bj), bi <= bj, of the upper triangle
  int bi = -1, bj = -1;
  if (tid < T * (T + 1) / 2) {
    int rem = tid;
    bi = 0;
    while (rem >= T - bi) {
      rem -= T - bi;
      ++bi;
    }
    bj = bi + rem;
  }

  float acc[kTile][kTile];
#pragma unroll
  for (int ii = 0; ii < kTile; ++ii) {
#pragma unroll
    for (int jj = 0; jj < kTile; ++jj) acc[ii][jj] = 0.f;
  }
  float bacc = 0.f;

  for (int k0 = 0; k0 < K; k0 += kKTile) {
    const int kt = min(kKTile, K - k0);
    for (int kk = tid; kk < kKTile; kk += blockDim.x) {
      float w = 0.f, r = 0.f;
      int j = -1;
      if (kk < kt) {
        w = w2[base + k0 + kk];
        r = rhs[base + k0 + kk];
        if (w != 0.f || r != 0.f) {
          j = idx[base + k0 + kk];
          if (j < 0 || j >= N) j = -1;
        }
      }
      s_w[kk] = w;
      s_r[kk] = r;
      s_i[kk] = j;
    }
    __syncthreads();
    for (int l = tid; l < kKTile * RP; l += blockDim.x) {
      const int kk = l / RP;
      const int c = l - kk * RP;
      const int j = s_i[kk];
      const float g =
          (j >= 0 && c < R) ? y[static_cast<size_t>(j) * R + c] : 0.f;
      s_g[l] = g;
      s_gw[l] = s_w[kk] * g;
    }
    __syncthreads();
    // two-level sums: each tile is summed from zero, then added to the
    // row's total, so rounding grows with kKTile + K / kKTile terms rather
    // than with K (K reaches 32,768)
    if (bi >= 0) {
      float part[kTile][kTile];
#pragma unroll
      for (int ii = 0; ii < kTile; ++ii) {
#pragma unroll
        for (int jj = 0; jj < kTile; ++jj) part[ii][jj] = 0.f;
      }
      for (int kk = 0; kk < kt; ++kk) {
        const float4 p =
            *reinterpret_cast<const float4*>(s_gw + kk * RP + bi * kTile);
        const float4 q =
            *reinterpret_cast<const float4*>(s_g + kk * RP + bj * kTile);
        const float pv[kTile] = {p.x, p.y, p.z, p.w};
        const float qv[kTile] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int ii = 0; ii < kTile; ++ii) {
#pragma unroll
          for (int jj = 0; jj < kTile; ++jj) {
            part[ii][jj] = fmaf(pv[ii], qv[jj], part[ii][jj]);
          }
        }
      }
#pragma unroll
      for (int ii = 0; ii < kTile; ++ii) {
#pragma unroll
        for (int jj = 0; jj < kTile; ++jj) acc[ii][jj] += part[ii][jj];
      }
    }
    if (tid < R) {
      float part = 0.f;
      for (int kk = 0; kk < kt; ++kk) {
        part = fmaf(s_r[kk], s_g[kk * RP + tid], part);
      }
      bacc += part;
    }
    __syncthreads();
  }

  const float rdg = ridge[blockIdx.x];
  float* a_row = a_out + static_cast<size_t>(blockIdx.x) * R * R;
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
          a_row[i * R + j] = v;
          a_row[j * R + i] = v;
        }
      }
    }
  }
  if (tid < R) b_out[static_cast<size_t>(blockIdx.x) * R + tid] = bacc;
}

}  // namespace

// Launches the build on `stream` and returns cudaGetLastError() (0 = ok).
// Device pointers: y [N, R] f32, idx [B, K] i32, w2/rhs [B, K] f32, ridge [B]
// f32, yty [R, R] f32 or null; outputs a [B, R, R] and b [B, R] f32. The
// caller guarantees B >= 1, K >= 0, N >= 1, 1 <= R <= 128.
extern "C" int pio_gramian_fused(const void* y, const void* idx, const void* w2,
                                 const void* rhs, const void* ridge,
                                 const void* yty, int B, int K, int N, int R,
                                 void* a, void* b, void* stream) {
  if (B < 1 || K < 0 || N < 1 || R < 1 || R > kMaxR) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int T = (R + kTile - 1) / kTile;
  const int blocks_of_a = T * (T + 1) / 2;
  const int need = blocks_of_a > R ? blocks_of_a : R;
  const int threads = (need + 31) / 32 * 32;
  const size_t smem =
      (2 * static_cast<size_t>(kKTile) * T * kTile + 3 * kKTile) * sizeof(float);
  gramian_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const int*>(idx),
      static_cast<const float*>(w2), static_cast<const float*>(rhs),
      static_cast<const float*>(ridge), static_cast<const float*>(yty), K, N,
      R, T, static_cast<float*>(a), static_cast<float*>(b));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pio_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
