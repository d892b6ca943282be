// Batched SPD solve (the ALS normal-equation solve), hand-written for Hopper
// (sm_90a).
//
// Replaces predictionio_tpu/ops/pallas_kernels.py::_spd_kernel (the Pallas
// body of spd_solve_t). For each system s it solves a[s] x[s] = b[s] with the
// TPU kernel's algorithm and guard:
//   forward, step j:  d2 = a[j][j];  inv_d = d2 > 0 ? rsqrt(d2) : 0;
//                     l = row j * inv_d  (L's column j; the block is symmetric)
//                     m = l - e_j;  a -= m (x) l  (row j now holds l)
//                     z_j = y[j] * inv_d;  y -= m * z_j
//   back, j = n-1..0: d = a[j][j];  inv = d > 0 ? 1/d : 0;
//                     x[j] = (y[j] - sum_{i>j} a[j][i] x[i]) * inv
// so an all-zero system solves to exactly 0 (never NaN), and a zero pivot of a
// singular PSD system gives a zero component instead of a division by zero.
// No Newton-Schulz: it stalls near 1e-2 relative error on ALS systems. Only
// the upper triangle of each system is read (kernel 3 writes A symmetric).
//
// Contract (checked by tests/test_torch_als_kernels.py and
// tests/test_torch_spd.py against the JAX kernel and np.linalg.solve, and by
// chip_smoke.py against the plain PyTorch version on the card): a [B, n, n]
// and b [B, n] f32, batch-major (the layout the gramian_fused kernel writes),
// any B and any n >= 1: n up to kMaxN = 128 through pio_spd_solve, wider n
// through pio_spd_solve_wide (the general-n path). The launch plan (path,
// padded width, warps a block, blocks, shared memory) is spd_launch_plan's in
// ops/cuda_kernels.py, which picks the path by n alone; each entry checks it
// against its own arithmetic.
//
// Design, n <= 64 (the "registers" path; ALS at rank 50). One warp owns one
// system, held in registers: lane c owns column c (slot 0) and column c + 32
// (slot 1) of the system padded to np_ (a multiple of 8), which is row c by
// symmetry. Slot s keeps rows 0..min(np_, 32(s+1))-1 only, since a column's
// rows below its diagonal are never needed: 88 floats a lane at np_ = 56.
// Columns n..np_-1 are the identity with b = 0, so their l is exactly 0 and a
// finite system's first n components do not change. Step j: every lane forms
// its own l_c (0 left of j) and publishes m_c = l_c - [c == j] with ONE
// shared store, as row j of U = L^T in its warp's own slice (a row a step, so
// one __syncwarp a step and no buffer reused); then every lane reads the m_r
// it needs as 16-byte broadcast loads and updates col[r] = fma(-m_r, l_c,
// col[r]) for r >= j, and its y. The next pivot is formed by its owner from
// its own l (m_{j+1} = l_{j+1}, the same bits) and broadcast with one shuffle
// before the barrier, so that chain skips the shared round trip. Back
// substitution runs column by column, the same sums as the TPU kernel's in
// another order: the owner of j forms x_j = y_j / d (1/d kept from the
// forward pass) and shuffles it out, and every lane c takes U[c][j] x_j off
// its y, reading its own row c of U in 16-byte words. Every index into a
// register array is a compile-time constant (the loops over j and r are
// unrolled; n is a predicate only), so nothing goes to local memory:
// chip_smoke.py fails on any spill. What sets the pace is each system's chain
// of dependent steps, with 13 warps an SM (152 registers allocated at np_ = 56); a
// block is one warp, so a short batch still spreads over the SMs.
//
// Design, 64 < n <= 128 (the "shared" path, the first version): one warp a
// system in shared memory (n * n + 2n floats: 66 KB at the ceiling, with the
// opt-in to more than 48 KB), lanes own columns of each trailing row, rows
// walked one after another; back substitution reduces each row's dot product
// across the warp with shuffles. Picked by n alone, never on a failure.
//
// Design, n > 128 (the "wide" path, the first version): one block a system,
// min(256, n rounded up to 32) threads, thread t owning columns t, t + T, ...
// of U. The upper triangle is packed row by row (n(n+1)/2 floats) in shared
// memory while it fits beside y and L's column (n <= 338 at 227 KB), and in
// a per-system slice of a device-memory scratch above that; the input is
// never written. The steps are the TPU kernel's, right-looking: step j forms
// L's column l_c = U[j][c] * inv_d (c >= j) in shared memory, then the owner
// of column c updates U[r][c] -= m_r * l_c for j <= r <= c and its y_c, two
// barriers a step. Back substitution runs column by column, as on the
// registers path: x_j = y_j * (d > 0 ? 1/d : 0), then every r < j takes
// U[r][j] x_j off y_r, one barrier a step. Picked by n alone.
//
// Bound at the training slice's shapes (165,000 systems an iteration at
// n = 50; H100 SXM data sheet: 3.35 TB/s, about 67 TFLOP/s fp32): reading
// the upper triangle, b and x is B * (n(n+1)/2 + 2n) * 4 bytes, 0.91 GB an
// iteration (0.271 ms, the bound); the whole A, which the first version read,
// 1.72 GB (0.512 ms); the solve needs about B * (n^3/3 + 2n^2) FLOP, 7.7
// GFLOP (0.11 ms). chip_smoke.py prints the bound of each launch, and the
// whole A's for comparison, beside its time.
// All arithmetic is fp32 on the CUDA cores.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 128;
constexpr int kWideThreads = 256;    // the most threads a block, wide path
constexpr int kWideMinBlocks = 4;    // launch bound: at most 64 registers
constexpr int kWideMaxN = 46340;     // n(n+1)/2 stays an int
constexpr int kMaxSmem = 232448;     // dynamic shared memory a block may opt into
constexpr int kRegMaxN = 64;     // the registers path takes n <= 64
constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;     // systems a block, shared path
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// the rows slot s of a lane keeps at padded width NP
__host__ __device__ constexpr int slot_rows(int np, int s) {
  return np < kWarp * (s + 1) ? np : kWarp * (s + 1);
}

// ---- the registers path (n <= 64) -------------------------------------------
// A warp's shared slice holds the rows of U = L^T: row j is the m_c that step
// j publishes (m_c = U[j][c] for c > j, 0 for c < j), kHistPad floats longer
// than the lanes' columns so that lane c reading its own row c in 16-byte
// words hits every bank once a quarter-warp.
constexpr int kHistPad = 4;
__host__ __device__ constexpr int hist_pitch(int np) {
  return kWarp * ((np + kWarp - 1) / kWarp) + kHistPad;
}
__host__ __device__ constexpr int hist_floats(int np) {
  return np * hist_pitch(np);
}

// A warp solves one system; the plan launches one warp a block. The kernel
// is written as for several warps a block (a warp index, its own slice of
// shared memory, a guard on B) under a bound of four warps, because that is
// the form that compiled to SPD_REGS with no spills at every width: the
// plainer form (sys = blockIdx.x) took 132 registers at np_ = 56, spilled at
// np_ = 16 and ran slower on the card, and a bound of one warp spilled at
// np_ = 24 and 32.
constexpr int kRegBoundThreads = 4 * kWarp;
template <int NP>
__global__ void __launch_bounds__(kRegBoundThreads)
spd_reg_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ x, int B, int n) {
  constexpr int S = (NP + kWarp - 1) / kWarp;
  constexpr int P = hist_pitch(NP);
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int sys = blockIdx.x * (blockDim.x / kWarp) + warp;
  float* s_u = smem + static_cast<size_t>(warp) * hist_floats(NP);
  if (sys >= B) return;  // warps share no barrier, so a spare warp may leave

  const size_t nn = static_cast<size_t>(n) * n;
  const float* a_g = a + static_cast<size_t>(sys) * nn;
  float col[S][NP];
  float y[S], dinv[S], xs[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int c = kWarp * s + lane;
#pragma unroll
    for (int r = 0; r < slot_rows(NP, s); ++r) {
      // padding columns are the identity; rows below the diagonal are 0
      float v = r == c ? 1.f : 0.f;
      if (c < n && r <= c) v = __ldg(a_g + r * n + c);
      col[s][r] = v;
    }
    y[s] = c < n ? __ldg(b + static_cast<size_t>(sys) * n + c) : 0.f;
    dinv[s] = 0.f;
    xs[s] = 0.f;
  }

  // Step j of the forward pass. Every lane also forms the pivot after its
  // own update, d = fma(-(l_j - 1), l_j, d2) (the owner's bits), and the
  // owner keeps 1/d for the back substitution: the approximate reciprocal
  // (2 ulp), since the IEEE division's slow-path call makes ptxas save
  // registers. The pivot of the next step comes from its owner's own l
  // (m_{j+1} = l_{j+1}: the same bits as its row update), so the shuffle
  // does not wait on the shared round trip.
  float d2 = __shfl_sync(kFull, col[0][0], 0);
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int sj = j / kWarp;
    const float inv_d = d2 > 0.f ? rsqrtf(d2) : 0.f;
    const float zj = __shfl_sync(kFull, y[sj], j % kWarp) * inv_d;
    const float lj = d2 * inv_d;
    const float dj = __fmaf_rn(-(lj - 1.f), lj, d2);
    if (lane == j % kWarp) dinv[sj] = dj > 0.f ? __fdividef(1.f, dj) : 0.f;
    float* row = s_u + j * P;
    float l[S], m[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (j < slot_rows(NP, s)) {
        const int c = kWarp * s + lane;
        l[s] = c >= j ? col[s][j] * inv_d : 0.f;
        m[s] = c == j ? l[s] - 1.f : l[s];
        row[c] = m[s];
      }
    }
    if (j + 1 < NP) {
      const int sn = (j + 1) / kWarp;
      d2 = __shfl_sync(kFull, __fmaf_rn(-l[sn], l[sn], col[sn][j + 1]),
                       (j + 1) % kWarp);
    }
    __syncwarp();
#pragma unroll
    for (int q = j / 4; q < NP / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(row)[q];
      const float mv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int r = 4 * q + t;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (r >= j && r < slot_rows(NP, s) && j < slot_rows(NP, s)) {
            col[s][r] = __fmaf_rn(-mv[t], l[s], col[s][r]);
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (j < slot_rows(NP, s)) y[s] = __fmaf_rn(-m[s], zj, y[s]);
    }
  }

  // Back substitution, column by column: the owner of j forms x_j = y_j / d
  // and broadcasts it, and every lane c takes U[c][j] x_j off its y (row c
  // of U, read from the slice; rows past np_ read the last row, unused).
  const float* urow[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int c = kWarp * s + lane;
    urow[s] = s_u + (c < NP ? c : NP - 1) * P;
  }
  float u[S][4];
#pragma unroll
  for (int j = NP - 1; j >= 0; --j) {
    const int sj = j / kWarp;
    const float xj = __shfl_sync(kFull, y[sj] * dinv[sj], j % kWarp);
    if (lane == j % kWarp) xs[sj] = xj;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (kWarp * s < j) {  // a lane of the slot lies left of j
        if (j % 4 == 3) {  // np_ - 1 is 3 mod 4: the first step loads
          const float4 v = reinterpret_cast<const float4*>(urow[s])[j / 4];
          u[s][0] = v.x, u[s][1] = v.y, u[s][2] = v.z, u[s][3] = v.w;
        }
        y[s] = __fmaf_rn(-u[s][j % 4], xj, y[s]);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int c = kWarp * s + lane;
    if (c < n) x[static_cast<size_t>(sys) * n + c] = xs[s];
  }
}

// ---- the shared path (64 < n <= 128): the first version ---------------------
__global__ void spd_shared_kernel(const float* __restrict__ a,
                                  const float* __restrict__ b,
                                  float* __restrict__ x, int B, int n) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int sys = blockIdx.x * (blockDim.x / kWarp) + warp;
  float* s_a = smem + static_cast<size_t>(warp) * (n * n + 2 * n);
  float* s_y = s_a + n * n;
  float* s_l = s_y + n;  // L's current column, then the solution
  if (sys >= B) return;

  const float* a_g = a + static_cast<size_t>(sys) * n * n;
  for (int r = 0; r < n; ++r) {  // the upper triangle only
    for (int c = r + lane; c < n; c += kWarp) s_a[r * n + c] = a_g[r * n + c];
  }
  for (int r = lane; r < n; r += kWarp) {
    s_y[r] = b[static_cast<size_t>(sys) * n + r];
  }
  __syncwarp();

  for (int j = 0; j < n; ++j) {
    const float d2 = s_a[j * n + j];
    const float inv_d = d2 > 0.f ? rsqrtf(d2) : 0.f;
    for (int c = j + lane; c < n; c += kWarp) s_l[c] = s_a[j * n + c] * inv_d;
    __syncwarp();
    const float zj = s_y[j] * inv_d;
    for (int r = j; r < n; ++r) {
      const float m = r == j ? s_l[j] - 1.f : s_l[r];
      for (int c = r + lane; c < n; c += kWarp) s_a[r * n + c] -= m * s_l[c];
    }
    for (int r = j + lane; r < n; r += kWarp) {
      const float m = r == j ? s_l[j] - 1.f : s_l[r];
      s_y[r] -= m * zj;
    }
    __syncwarp();
  }

  for (int r = lane; r < n; r += kWarp) s_l[r] = 0.f;
  __syncwarp();
  for (int j = n - 1; j >= 0; --j) {
    float dot = 0.f;
    for (int i = j + 1 + lane; i < n; i += kWarp) {
      dot = fmaf(s_a[j * n + i], s_l[i], dot);
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      dot += __shfl_xor_sync(kFull, dot, off);
    }
    if (lane == 0) {
      const float d = s_a[j * n + j];
      const float inv = d > 0.f ? 1.f / d : 0.f;
      s_l[j] = (s_y[j] - dot) * inv;
    }
    __syncwarp();
  }
  for (int r = lane; r < n; r += kWarp) {
    x[static_cast<size_t>(sys) * n + r] = s_l[r];
  }
}

// ---- the wide path (n > kMaxN): the first version ---------------------------
// Index of (r, c), r <= c < n, in the row-major packed upper triangle.
__device__ __forceinline__ size_t packed(int r, int c, int n) {
  return static_cast<size_t>(r) * n - static_cast<size_t>(r) * (r - 1) / 2 + (c - r);
}

__global__ void __launch_bounds__(kWideThreads, kWideMinBlocks)
spd_wide_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ x, float* __restrict__ scratch, int n) {
  extern __shared__ __align__(16) float smem[];
  const size_t sys = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  float* s_y = smem;      // [n] the right-hand side, then the forward result
  float* s_l = smem + n;  // [n] L's column of the step
  const size_t tri = static_cast<size_t>(n) * (n + 1) / 2;
  float* u = scratch != nullptr ? scratch + sys * tri : smem + 2 * n;

  const float* a_g = a + sys * n * n;
  for (int r = 0; r < n; ++r) {  // the upper triangle only
    for (int c = r + tid; c < n; c += T) u[packed(r, c, n)] = a_g[static_cast<size_t>(r) * n + c];
  }
  for (int r = tid; r < n; r += T) s_y[r] = b[sys * n + r];
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    const float d2 = u[packed(j, j, n)];
    const float inv_d = d2 > 0.f ? rsqrtf(d2) : 0.f;
    const float zj = s_y[j] * inv_d;
    for (int c = j + tid; c < n; c += T) s_l[c] = u[packed(j, c, n)] * inv_d;
    __syncthreads();
    const float mj = s_l[j] - 1.f;
    for (int c = j + tid; c < n; c += T) {
      const float lc = s_l[c];
      for (int r = j; r <= c; ++r) {
        const float m = r == j ? mj : s_l[r];
        const size_t e = packed(r, c, n);
        u[e] = __fmaf_rn(-m, lc, u[e]);
      }
      s_y[c] = __fmaf_rn(-(c == j ? mj : lc), zj, s_y[c]);
    }
    __syncthreads();
  }

  for (int j = n - 1; j >= 0; --j) {
    const float d = u[packed(j, j, n)];
    const float xj = s_y[j] * (d > 0.f ? 1.f / d : 0.f);
    if (tid == 0) x[sys * n + j] = xj;
    for (int r = tid; r < j; r += T) s_y[r] = __fmaf_rn(-u[packed(r, j, n)], xj, s_y[r]);
    __syncthreads();
  }
}

template <int NP>
cudaError_t launch_reg(const float* a, const float* b, float* x, int B, int n,
                       int smem, cudaStream_t st) {
  spd_reg_kernel<NP><<<B, kWarp, smem, st>>>(a, b, x, B, n);
  return cudaGetLastError();
}

}  // namespace

// Launches the solve on `stream` and returns cudaGetLastError() (0 = ok).
// Device pointers: a [B, n, n] f32, b [B, n] f32, x [B, n] f32 (output). The
// plan: path (0 registers, 1 shared), the padded width np, warps (systems) a
// block, blocks, and dynamic shared memory in bytes. A plan that does not
// match this arithmetic is refused (cudaErrorInvalidValue).
extern "C" int pio_spd_solve(const void* a, const void* b, void* x, int B,
                             int n, int path, int np, int warps, int blocks,
                             int smem, void* stream) {
  if (B < 1 || n < 1 || n > kMaxN || warps < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool regs = n <= kRegMaxN;
  bool ok = path == (regs ? 0 : 1) && np == (n + 7) / 8 * 8 &&
            blocks == (B + warps - 1) / warps;
  if (regs) {
    ok = ok && warps == 1 &&
         smem == hist_floats(np) * static_cast<int>(sizeof(float));
  } else {
    const size_t per_warp = static_cast<size_t>(n * n + 2 * n) * sizeof(float);
    int want = static_cast<int>(kDefaultSmem / per_warp);
    want = want < 1 ? 1 : (want > kMaxWarps ? kMaxWarps : want);
    ok = ok && warps == want && static_cast<size_t>(smem) == per_warp * want;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* xf = static_cast<float*>(x);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!regs) {
    if (static_cast<size_t>(smem) > kDefaultSmem) {
      const cudaError_t err = cudaFuncSetAttribute(
          spd_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    spd_shared_kernel<<<blocks, warps * kWarp, smem, st>>>(af, bf, xf, B, n);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = cudaErrorInvalidValue;
  switch (np) {
    case 8: err = launch_reg<8>(af, bf, xf, B, n, smem, st); break;
    case 16: err = launch_reg<16>(af, bf, xf, B, n, smem, st); break;
    case 24: err = launch_reg<24>(af, bf, xf, B, n, smem, st); break;
    case 32: err = launch_reg<32>(af, bf, xf, B, n, smem, st); break;
    case 40: err = launch_reg<40>(af, bf, xf, B, n, smem, st); break;
    case 48: err = launch_reg<48>(af, bf, xf, B, n, smem, st); break;
    case 56: err = launch_reg<56>(af, bf, xf, B, n, smem, st); break;
    case 64: err = launch_reg<64>(af, bf, xf, B, n, smem, st); break;
  }
  return static_cast<int>(err);
}

// Launches the wide path (n > kMaxN) on `stream` and returns
// cudaGetLastError() (0 = ok). Device pointers as pio_spd_solve's, plus
// scratch [B, n(n+1)/2] f32 when the packed triangle does not fit in shared
// memory (else null). The plan: threads a block, blocks (= B) and dynamic
// shared memory in bytes; a plan that does not match this arithmetic is
// refused (cudaErrorInvalidValue).
extern "C" int pio_spd_solve_wide(const void* a, const void* b, void* x,
                                  void* scratch, int B, int n, int threads,
                                  int blocks, int smem, void* stream) {
  if (B < 1 || n <= kMaxN || n > kWideMaxN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tri = static_cast<long long>(n) * (n + 1) / 2;
  const long long in_smem = 4 * (tri + 2LL * n);
  const bool fits = in_smem <= kMaxSmem;
  const int want_threads = (n + 31) / 32 * 32 < kWideThreads ? (n + 31) / 32 * 32 : kWideThreads;
  const bool ok = threads == want_threads && blocks == B &&
                  smem == (fits ? in_smem : 8LL * n) &&
                  (fits ? scratch == nullptr : scratch != nullptr);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<size_t>(smem) > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        spd_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  spd_wide_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(x), static_cast<float*>(scratch), n);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread, local (spilled) bytes and static shared memory of every
// solve kernel, three ints each, in this order: the registers kernel at
// np = 8, 16, ..., 64, the shared kernel, then the wide kernel. Returns the first error of
// cudaFuncGetAttributes.
extern "C" int pio_spd_solve_attrs(int* out) {
  const void* kernels[] = {
      reinterpret_cast<const void*>(spd_reg_kernel<8>),
      reinterpret_cast<const void*>(spd_reg_kernel<16>),
      reinterpret_cast<const void*>(spd_reg_kernel<24>),
      reinterpret_cast<const void*>(spd_reg_kernel<32>),
      reinterpret_cast<const void*>(spd_reg_kernel<40>),
      reinterpret_cast<const void*>(spd_reg_kernel<48>),
      reinterpret_cast<const void*>(spd_reg_kernel<56>),
      reinterpret_cast<const void*>(spd_reg_kernel<64>),
      reinterpret_cast<const void*>(spd_shared_kernel),
      reinterpret_cast<const void*>(spd_wide_kernel),
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
