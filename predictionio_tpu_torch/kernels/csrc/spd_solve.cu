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
// through pio_spd_solve_blocked while its tiles fit in one block's shared
// memory (n <= 304), through pio_spd_solve_cluster while they fit in a
// cluster's (n <= 768) and pio_spd_solve_tiled above (tiles in device
// memory). pio_spd_solve_wide (the general-n first version) takes no n of
// its own: a plan forces it as the yardstick every path above n = 128 is
// held to bit for bit. The launch plan (path, padded width, warps a block,
// blocks, shared memory, cluster size; the tiled path's tiles, panels,
// threads and blocks of each launch) is spd_launch_plan's in
// ops/cuda_kernels.py, which picks the path by n alone; each entry checks
// it against its own arithmetic.
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
// Design, 128 < n <= 304 (the "blocked" path; ALS at ranks 129-304): one
// block of 256 threads a system. The upper triangle, padded to t * 16
// columns with the identity (b = 0 there: the first n components keep their
// bits), sits in shared memory as 16 x 16 tiles (I <= J, each contiguous),
// copied in with cp.async, every copy in flight at once. A panel is 16
// columns: one warp runs the TPU kernel's 16 right-looking steps on the
// diagonal tile in registers, lane c on column c, taking the other lanes' l
// by shuffle; every thread then steps one column of the strip right of the
// panel against the warp's l and m, writing L's rows to a buffer of their
// own (row j of U after step j is not l: back substitution reads the stored
// row, the trailing update l); then the trailing tiles take fma(-l_r(k),
// l_c(k), U[r][c]) for k ascending, a 4 x 4 register tile a thread, while the
// warp brings the next diagonal tile up to date first and steps it
// (lookahead): two barriers a panel where the wide path has 2n. Back
// substitution runs by panels, one barrier a panel: warp 0 solves the panel
// (x_j = y_j * (d > 0 ? 1/d : 0), j descending, by shuffles), the others take
// the previous panel's x off the rows above. Every element of U and y takes
// the wide path's FMAs in the wide path's order, so the answer is the wide
// kernel's bit for bit (chip_smoke.py holds them equal). What sets the pace
// at n = 256 (one 157 KB block an SM): the warp's chain of 16 dependent steps
// a panel, shuffle and rsqrt each, and the trailing update at about 60 % of
// the FP32 rate (chip_smoke.py::spd_blocked_knockouts times each phase).
// 64 registers, no local memory (its launch bound; 4 blocks an SM at n = 129).
//
// Design, 304 < n <= 768 (the "cluster" path; ALS at ranks 305-768): the
// blocked path's tiles, steps and order spread over a thread-block cluster
// of C = 2, 4 or 8 blocks a system (the smallest C whose largest block fits
// in 227 KB: n <= 432, 576, 768), launched with cudaLaunchKernelEx and the
// cluster-dimension attribute. Tile column J, its tiles (I, J) for I <= J
// and y's segment J live in block J mod C, which copies them in with
// cp.async (the input is never written); L's strip rows [nb][np] and the
// diagonal tile's L rows, inv_d and z_j are copied in every block. Panel
// p: the strip, each block its own columns right of the panel against the
// diagonal tile's L rows, each column's L rows pushed into every block's
// strip buffer (distributed shared memory, DSMEM); a cluster barrier; the
// trailing update, each block its own tiles in 4 x 4 register tiles from
// its own copy of the strip, while warp 0 of the owner of panel p + 1
// brings that diagonal tile up to date, steps it and pushes its L rows
// (lookahead); a cluster barrier (its release and acquire make the pushed
// stores visible). A block writes another's strip buffer only in a strip
// and its diagonal rows only in a trailing update, and reads each only in
// the other phase, so one buffer of each and two barriers a panel do. Back
// substitution by panels, one cluster barrier a panel: the owner of panel p
// takes panel p + 1's x off the panel's rows and solves the panel on warp
// 0 (that x pushed to it, its row of tile (p, p + 1) read a panel ahead, so
// no DSMEM load waits in the chain); meanwhile the owner of panel p + 1
// takes its x off every row above panel p (column p + 1's tiles are its
// own), each y_r read and written in the block that holds it. Every element of U and y has one owner and takes the blocked path's
// FMAs in its order, so the answer is the wide kernel's bit for bit
// (chip_smoke.py holds them equal). A last cluster barrier keeps every block
// until no other can touch its memory. No fallback: a cluster launch the
// card refuses returns its error. What sets the pace (one 136-226 KB block
// an SM; chip_smoke.py::spd_cluster_knockouts times each phase): the
// cluster barriers and the waits at them (26-37 %), back substitution's
// barrier a panel (16-20 %) and the diagonal warp's chain, not the FMAs.
// 166-168 registers (184 at C = 8), no local memory; a launch bound of two
// blocks an SM spilled.
//
// Design, n > 768 (the "tiled" path; ALS at ranks 769 and up): the upper
// triangle, padded to t * nb columns with the identity (b = 0 there; nb =
// 64), is copied once into a working copy in device memory as nb x nb
// tiles (I <= J), beside y, one panel's rows of L
// [nb][t nb] and the panel's diagonal L rows, inv_d and z_j
// (tl_system_floats: about 60 % of A's bytes; the wrapper cuts a call so
// that the working copies stay within 2 GiB). The input is never written.
// One C entry issues every launch of a call on the caller's stream, 3t
// launches (tl_for_each_launch): the copy (a block a tile); for each panel
// p its diagonal tile (one warp a system: the TPU kernel's steps on
// lane-owned columns, as two 32-wide sub-panels with their strip and
// rank-32 update between them, so that the unrolled code stays short),
// its strip (128 columns a block, each column's nb rows stepped in
// registers, L's rows written to the panel buffer) and its trailing update
// (one block a (system, tile (I, J), p < I <= J), so that B = 64 still
// fills the card: L's rows at the tile's rows and columns copied into
// shared memory by cp.async while each thread loads its 4 x 4 register
// tile, then k over the panel's steps ascending); back substitution (one
// block a system, sub-panels of 32 rows from the last, as on the blocked
// path). Offsets past a system are 64-bit. Every element of U and y takes
// the wide kernel's FMAs in its order, so the answer is the wide kernel's
// bit for bit (chip_smoke.py holds them equal). What sets the pace
// (chip_smoke.py's device time by kernel, n = 1,024, B = 64; each phase is
// a kernel of its own): the trailing update 53 %, the diagonal chains 15 %,
// the strips 14 %, back substitution 11 %, the copy 7 %. The update is bound
// by its memory traffic and the latency around it, not by its FMAs: cut of
// them it keeps 71-78 % of its time (spd_tiled_knockouts; each panel reads
// and writes the trailing tiles and reads L's rows from L2). Registers: the
// update 50, the strip 144, the diagonal tile 168, back substitution 68, the
// copy 32; no local memory. Tried and dropped (PERF.md, Findings): nb = 32 (no
// faster at n = 769, 6-25 % slower above), the next panel's diagonal tile
// and strip on a second stream beside the trailing update (4-7 % slower:
// the one-warp chain slows beside the update's blocks), 8 x 8 register
// tiles in the update (6 % slower), two rows a thread in back substitution.
//
// Design, the "wide" path (the first version; the tiled path's yardstick,
// launched only when a plan forces it): one block a system,
// min(256, n rounded up to 32) threads, thread t owning columns t, t + T, ...
// of U. The upper triangle is packed row by row (n(n+1)/2 floats) in shared
// memory while it fits beside y and L's column (n <= 338 at 227 KB), and in
// a per-system slice of a device-memory scratch above that; the input is
// never written. The steps are the TPU kernel's, right-looking: step j forms
// L's column l_c = U[j][c] * inv_d (c >= j) in shared memory, then the owner
// of column c updates U[r][c] -= m_r * l_c for j <= r <= c and its y_c, two
// barriers a step. Back substitution runs column by column, as on the
// registers path: x_j = y_j * (d > 0 ? 1/d : 0), then every r < j takes
// U[r][j] x_j off y_r, one barrier a step.
//
// Bound at the training slice's shapes (165,000 systems an iteration at
// n = 50; H100 SXM data sheet: 3.35 TB/s, about 67 TFLOP/s fp32): reading
// the upper triangle, b and x is B * (n(n+1)/2 + 2n) * 4 bytes, 0.91 GB an
// iteration (0.271 ms, the bound); the whole A, which the first version read,
// 1.72 GB (0.512 ms); the solve needs about B * (n^3/3 + 2n^2) FLOP, 7.7
// GFLOP (0.11 ms). At the wider systems the operations bound: 4,096 systems
// take 45.8 / 168 / 350 us at n = 129 / 200 / 256, and the users' bucket of
// ML-20M at rank 200 (97,972 systems) 4.02 ms. chip_smoke.py prints the
// bound of each launch, and the whole A's for comparison, beside its time.
// All arithmetic is fp32 on the CUDA cores.

#include <cooperative_groups.h>
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

// ---- the blocked path (kMaxN < n <= the blocked ceiling) --------------------
constexpr int kBlkNb = 16;         // the tile width nb: a panel's columns
constexpr int kBlkThreads = 256;   // threads a block
constexpr int kBlkMinBlocks = 4;   // launch bound: at most 64 registers

// tiles of the upper triangle at t tiles a side, and the block's dynamic
// shared memory in bytes: the tiles, L's strip rows [nb][t nb], y [t nb], the
// diagonal tile's L rows [nb][nb], inv_d and z_j of the panel's steps [nb]
// each, and the tile table [tiles]
__host__ __device__ constexpr long long blk_tiles(int t) {
  return static_cast<long long>(t) * (t + 1) / 2;
}
__host__ __device__ constexpr long long blk_smem_bytes(int t, int nb) {
  return 4 * (blk_tiles(t) * nb * nb + static_cast<long long>(nb) * t * nb + t * nb + nb * nb +
              2LL * nb + blk_tiles(t));
}
// index of tile (i, j), i <= j, row-major over the upper triangle of tiles
__device__ __forceinline__ int blk_tile(int i, int j, int t) {
  return i * t - i * (i - 1) / 2 + (j - i);
}

// One 4-byte copy from device memory into shared memory (cp.async, L1 and
// L2), so that a block has every copy of its system in flight at once.
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr), "l"(src) : "memory");
}

// The lane's index in its warp, read from the hardware where it is used.
__device__ __forceinline__ int lane_id() {
  int id;
  asm volatile("mov.u32 %0, %%laneid;" : "=r"(id));
  return id;
}

// The 4-float group g of a shared row as four floats (16-byte aligned).
__device__ __forceinline__ void load4(const float* row, int g, float* out) {
  const float4 v = reinterpret_cast<const float4*>(row)[g];
  out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
}

// y_r with a panel's x taken off, j descending: y_r = fma(-U[r][j], x_j, y_r)
// over the panel's NB columns of row r (urow) and its x (16-byte aligned).
template <int NB>
__device__ __forceinline__ float take_panel(const float* urow, const float* xp, float yr) {
#pragma unroll
  for (int g = NB / 4 - 1; g >= 0; --g) {
    float u[4], xv[4];
    load4(urow, g, u);
    load4(xp, g, xv);
#pragma unroll
    for (int i = 3; i >= 0; --i) yr = __fmaf_rn(-u[i], xv[i], yr);
  }
  return yr;
}

// One panel's diagonal tile on one warp, lane c on column c (rows 0..c
// held in registers): the TPU kernel's NB right-looking steps. Step j
// publishes L's row j of the tile (l_c, 0 left of j) to s_ld for the strip,
// and the step's inv_d and z_j; the lanes take each other's l by shuffle, and
// the next pivot comes from its owner's own l (m_{j+1} = l_{j+1}: the bits of
// its row update), so no step waits on shared memory. The tile's rows go back to shared memory (row j as updated by step j,
// which back substitution reads), and y_p to s_yp.
template <int NB>
__device__ __forceinline__ void blk_panel(float* diag, float* s_yp, float* s_ld, float* s_inv,
                                          float* s_z, int lane) {
  const bool live = lane < NB;
  float col[NB];
#pragma unroll
  for (int r = 0; r < NB; ++r) col[r] = live ? diag[r * NB + lane] : 0.f;
  float yv = live ? s_yp[lane] : 0.f;
  float d2 = __shfl_sync(kFull, col[0], 0);
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const float inv_d = d2 > 0.f ? rsqrtf(d2) : 0.f;
    const float zj = __shfl_sync(kFull, yv, j) * inv_d;
    const float l = lane >= j ? col[j] * inv_d : 0.f;
    float* lrow = s_ld + j * NB;
    if (live) lrow[lane] = l;
    if (lane == 0) s_inv[j] = inv_d, s_z[j] = zj;
    if (j + 1 < NB) d2 = __shfl_sync(kFull, __fmaf_rn(-l, l, col[j + 1]), j + 1);
    const float mj = __shfl_sync(kFull, l, j) - 1.f;
#pragma unroll
    for (int r = j; r < NB; ++r) {
      const float m = r == j ? mj : __shfl_sync(kFull, l, r);
      if (r <= lane) col[r] = __fmaf_rn(-m, l, col[r]);
    }
    if (lane >= j) yv = __fmaf_rn(-(lane == j ? mj : l), zj, yv);
  }
  if (live) {
#pragma unroll
    for (int r = 0; r < NB; ++r) {
      if (r <= lane) diag[r * NB + lane] = col[r];
    }
    s_yp[lane] = yv;
  }
}

// One strip column c of panel p (the panel's NB rows of column c, at tcol
// with row pitch NB): the panel's NB steps against the diagonal tile's L rows
// (s_ld), l_c of step j = U[j][c] * inv_d into L's buffer (lcol, row pitch
// np), y_c = fma(-l_c, z_j, y_c). The regions are disjoint, so the next
// step's loads need not wait on this step's stores.
template <int NB>
__device__ __forceinline__ float blk_strip(float* __restrict__ tcol, float* __restrict__ lcol,
                                           int np, const float* __restrict__ s_ld,
                                           const float* __restrict__ s_inv,
                                           const float* __restrict__ s_z, float yc) {
  float col[NB];
#pragma unroll
  for (int r = 0; r < NB; ++r) col[r] = tcol[r * NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const float lc = col[j] * s_inv[j];
    lcol[j * np] = lc;
    float m[NB];
#pragma unroll
    for (int g = j / 4; g < NB / 4; ++g) load4(s_ld + j * NB, g, m + 4 * g);
    const float mj = m[j] - 1.f;
#pragma unroll
    for (int r = j; r < NB; ++r) col[r] = __fmaf_rn(-(r == j ? mj : m[r]), lc, col[r]);
    yc = __fmaf_rn(-lc, s_z[j], yc);
  }
#pragma unroll
  for (int r = 0; r < NB; ++r) tcol[r * NB] = col[r];
  return yc;
}

// One 4 x 4 register tile of the trailing update at tu (row pitch NB): U[r][c]
// = fma(-l_r(k), l_c(k), U[r][c]) for k over the panel's NB steps ascending,
// l_r from lr and l_c from lc (L's buffer, row pitch np); on the diagonal
// (`upper`) only its upper part is stored.
template <int NB>
__device__ __forceinline__ void blk_update4(float* tu, const float* lr, const float* lc, int np,
                                            bool upper) {
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) load4(tu + i * NB, 0, acc[i]);
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    float rv[4], cv[4];
    load4(lr + k * np, 0, rv);
    load4(lc + k * np, 0, cv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int jx = 0; jx < 4; ++jx) acc[i][jx] = __fmaf_rn(-rv[i], cv[jx], acc[i][jx]);
    }
  }
  if (upper) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int jx = i; jx < 4; ++jx) tu[i * NB + jx] = acc[i][jx];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(tu + i * NB) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

template <int NB>
__global__ void __launch_bounds__(kBlkThreads, kBlkMinBlocks)
spd_blocked_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ x, int n, int t) {
  constexpr int TF = NB * NB;  // floats a tile, row-major
  constexpr int G = NB / 4;    // 4 x 4 register tiles a tile side
  constexpr int kWarps = kBlkThreads / kWarp;
  extern __shared__ __align__(16) float smem[];
  const int np = t * NB;
  const int ntiles = t * (t + 1) / 2;
  float* s_u = smem;                   // the tiles of U
  float* s_l = s_u + ntiles * TF;      // [NB][np]: row k, l_c of the panel's step k (strip)
  float* s_y = s_l + NB * np;          // [np]
  float* s_ld = s_y + np;              // [NB][NB]: row k, l_c of step k in the diagonal tile
  float* s_inv = s_ld + TF;            // [NB] inv_d of the panel's steps
  float* s_z = s_inv + NB;             // [NB] z_j of the panel's steps
  int* s_ij = reinterpret_cast<int*>(s_z + NB);  // [ntiles] (I << 16) | J
  const size_t sys = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;

  for (int q = tid; q < ntiles; q += kBlkThreads) {
    int i = 0, r = q;
    while (r >= t - i) r -= t - i++;
    s_ij[q] = (i << 16) | (i + r);
  }
  for (int c = tid; c < np; c += kBlkThreads) s_y[c] = c < n ? b[sys * n + c] : 0.f;
  // the upper triangle, a warp a row, copied without waiting on each load;
  // padding is the identity, and the part of a diagonal tile below the
  // diagonal is 0 (never read)
  const float* a_g = a + sys * n * n;
  for (int r = warp; r < np; r += kWarps) {
    const int ti = r / NB;
    for (int c = ti * NB + lane; c < np; c += kWarp) {
      float* dst = s_u + blk_tile(ti, c / NB, t) * TF + (r % NB) * NB + c % NB;
      if (c >= r && c < n) {
        copy4(dst, a_g + static_cast<size_t>(r) * n + c);
      } else {
        *dst = r == c ? 1.f : 0.f;
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // Panel p: its diagonal tile was stepped by warp 0 already (during panel
  // p - 1's trailing update; panel 0's in the pass p = -1); the strip, then
  // the trailing update by warps 1.. while warp 0 brings panel p + 1's
  // diagonal tile up to date and steps it. Two barriers a panel.
  for (int p = -1; p < t; ++p) {
    const int e = (p + 1) * NB;  // the first column right of panel p
    if (p >= 0) {
      // the strip: the panel's rows right of it, a thread a column, the same
      // steps against the diagonal warp's l and m, and y right of the panel
      for (int c = e + tid; c < np; c += kBlkThreads) {
        s_y[c] = blk_strip<NB>(s_u + blk_tile(p, c / NB, t) * TF + c % NB, s_l + c, np, s_ld,
                               s_inv, s_z, s_y[c]);
      }
      __syncthreads();
    }
    // the trailing update: every tile right of and below the panel, a 4 x 4
    // register tile a thread, k over the panel's steps ascending; a warp
    // takes two tiles' 32 register tiles, so its 16-byte loads of L's rows
    // touch 16 + 32 consecutive floats
    if (p + 1 < t) {
      const int qd = blk_tile(p + 1, p + 1, t);  // the next diagonal tile
      if (warp == 0) {
        // the lane id read here, not kept across the panel loop (64
        // registers hold nothing more)
        const int me = lane_id();
        const int rg = me / G, cg = me % G;
        if (p >= 0 && me < G * G && rg <= cg) {
          blk_update4<NB>(s_u + qd * TF + 4 * rg * NB + 4 * cg, s_l + e + 4 * rg,
                          s_l + e + 4 * cg, np, rg == cg);
        }
        __syncwarp();
        blk_panel<NB>(s_u + qd * TF, s_y + e, s_ld, s_inv, s_z, lane);
      } else if (p >= 0) {
        const int count = (ntiles - qd - 1) * G * G;
        for (int f = tid - kWarp; f < count; f += kBlkThreads - kWarp) {
          const int q = qd + 1 + f / (G * G);
          const int rg = f / G % G, cg = f % G;
          const int ij = s_ij[q];
          const int ti = ij >> 16, tj = ij & 0xffff;
          if (ti == tj && rg > cg) continue;  // below the diagonal
          blk_update4<NB>(s_u + q * TF + 4 * rg * NB + 4 * cg, s_l + ti * NB + 4 * rg,
                          s_l + tj * NB + 4 * cg, np, ti == tj && rg == cg);
        }
      }
    }
    __syncthreads();
  }

  // Back substitution by panels from the last, one barrier a panel: warp 0
  // takes panel p + 1's x off the rows of panel p and then solves panel p,
  // x_j = y_j * (d > 0 ? 1/d : 0) with j descending (lane j forms its 1/d
  // before the chain), each x_j taken off the panel's rows above j;
  // meanwhile the other warps take panel p + 1's x off every row above panel
  // p. Each y_r takes its x_j with j descending, as on the wide path. L's
  // buffer holds x.
  float* s_x = s_l;
  for (int p = t - 1; p >= 0; --p) {
    const int s = p * NB;
    const int e = s + NB;
    if (warp == 0) {
      // lane r holds row r of the diagonal tile (lanes past NB a copy of row
      // 0, unused), so the chain is shuffles and FMAs only
      const float* diag = s_u + blk_tile(p, p, t) * TF;
      float urow[NB];
#pragma unroll
      for (int g = 0; g < NB / 4; ++g) load4(diag + (lane % NB) * NB, g, urow + 4 * g);
      float yv = lane < NB ? s_y[s + lane] : 0.f;
      const float d = lane < NB ? diag[lane * (NB + 1)] : 0.f;
      const float dinv = d > 0.f ? 1.f / d : 0.f;
      if (p + 1 < t && lane < NB) {
        yv = take_panel<NB>(s_u + blk_tile(p, p + 1, t) * TF + lane * NB, s_x + e, yv);
      }
      float xs = 0.f;
#pragma unroll
      for (int j = NB - 1; j >= 0; --j) {
        const float xj = __shfl_sync(kFull, yv * dinv, j);
        if (lane == j) xs = xj;
        if (lane < j) yv = __fmaf_rn(-urow[j], xj, yv);
      }
      if (lane < NB) {
        s_x[s + lane] = xs;
        if (s + lane < n) x[sys * n + s + lane] = xs;
      }
    } else if (p + 1 < t) {
      for (int r = tid - kWarp; r < s; r += kBlkThreads - kWarp) {
        s_y[r] = take_panel<NB>(s_u + blk_tile(r / NB, p + 1, t) * TF + (r % NB) * NB, s_x + e,
                                s_y[r]);
      }
    }
    __syncthreads();
  }
}

// ---- the cluster path (the blocked ceiling < n <= the cluster ceiling) ------
constexpr int kClThreads = 256;   // threads a block
constexpr int kClMinBlocks = 1;   // launch bound: a block an SM (its shared memory allows no more)
constexpr int kClSizes[] = {2, 4, 8};  // cluster sizes, smallest first

// Tile columns block `rank` of a cluster of c owns at t tiles a side: J =
// rank, rank + c, ... < t.
__host__ __device__ constexpr int cl_cols(int t, int c, int rank) {
  return rank < t ? (t - 1 - rank) / c + 1 : 0;
}
// its tiles: (I, J), I <= J, over those columns
__host__ __device__ constexpr long long cl_tiles(int t, int c, int rank) {
  return static_cast<long long>(cl_cols(t, c, rank)) * (rank + 1) +
         static_cast<long long>(c) * cl_cols(t, c, rank) * (cl_cols(t, c, rank) - 1) / 2;
}
__host__ __device__ constexpr long long cl_max_tiles(int t, int c) {
  long long most = 0;
  for (int r = 0; r < c; ++r) most = cl_tiles(t, c, r) > most ? cl_tiles(t, c, r) : most;
  return most;
}
// Dynamic shared memory of every block of the cluster, bytes: the blocked
// path's terms with the largest block's tiles (every block lays its memory
// out alike, so a buffer lies at the same offset in each and a block
// addresses another's through the offset of its own).
__host__ __device__ constexpr long long cl_smem_bytes(int t, int c, int nb) {
  return 4 * (cl_max_tiles(t, c) * nb * nb + static_cast<long long>(nb) * t * nb + t * nb +
              nb * nb + 2LL * nb + cl_max_tiles(t, c));
}
// this block's columns left of tile column i: the index, among its
// columns, of its first column at or right of i
__device__ __forceinline__ int cl_first(int i, int c, int rank) {
  return i <= rank ? 0 : (i - rank + c - 1) / c;
}
// The index of this block's first tile of row i (its tiles lie row-major:
// row i holds m - cl_first(i) of them, m its columns).
__device__ __forceinline__ int cl_row_start(int i, int m, int c, int rank) {
  const int u = i - 1 - rank;  // rows rank + 1 .. i - 1 start right of an own column
  if (u <= 0) return i * m;
  const int q = u / c, r = u % c;
  return i * m - (c * q * (q + 1) / 2 + r * (q + 1));
}
// the index of tile (i, j) of the block `rank` that holds column j
__device__ __forceinline__ int cl_tile(int i, int j, int m, int c, int rank) {
  return cl_row_start(i, m, c, rank) + (j - rank) / c - cl_first(i, c, rank);
}

// A strip column's L rows (NB floats at pitch np, just written by this
// thread) into the same place in every other block of the cluster.
template <int NB, int C>
__device__ __forceinline__ void cl_push_column(const cooperative_groups::cluster_group& cluster,
                                               int rank, float* lcol, int np) {
  float v[NB];
#pragma unroll
  for (int r = 0; r < NB; ++r) v[r] = lcol[r * np];
#pragma unroll
  for (int q = 1; q < C; ++q) {
    float* dst = cluster.map_shared_rank(lcol, (rank + q) % C);
#pragma unroll
    for (int r = 0; r < NB; ++r) dst[r * np] = v[r];
  }
}

// The panel's diagonal L rows, inv_d and z_j (s_ld, s_inv, s_z: NB * NB +
// 2 NB floats in a row) into every other block, by one warp in 16-byte words.
template <int NB, int C>
__device__ __forceinline__ void cl_push_panel(const cooperative_groups::cluster_group& cluster,
                                              int rank, float* s_ld, int lane) {
  constexpr int V = (NB * NB + 2 * NB) / 4;
  const float4* src = reinterpret_cast<const float4*>(s_ld);
  for (int i = lane; i < (C - 1) * V; i += kWarp) {
    float4* dst = reinterpret_cast<float4*>(cluster.map_shared_rank(s_ld, (rank + 1 + i / V) % C));
    dst[i % V] = src[i % V];
  }
}

// One system on a cluster of C blocks, the blocked path's arithmetic: tile
// column J (the tiles (I, J), I <= J) and y's segment J in block J mod C.
template <int NB, int C>
__global__ void __launch_bounds__(kClThreads, kClMinBlocks)
spd_cluster_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ x, int n, int t, int tmax) {
  constexpr int TF = NB * NB;  // floats a tile, row-major
  constexpr int G = NB / 4;    // 4 x 4 register tiles a tile side
  constexpr int kWarps = kClThreads / kWarp;
  extern __shared__ __align__(16) float smem[];
  const cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int np = t * NB;
  const int m = cl_cols(t, C, rank);                  // this block's tile columns
  const int own = static_cast<int>(cl_tiles(t, C, rank));
  float* s_u = smem;                                  // its tiles, row-major
  float* s_l = s_u + static_cast<size_t>(tmax) * TF;  // [NB][np]: row k, l_c of the panel's step k
  float* s_y = s_l + NB * np;                         // [np] (its segments)
  float* s_ld = s_y + np;                             // [NB][NB] the diagonal tile's L rows
  float* s_inv = s_ld + TF;                           // [NB] inv_d of the panel's steps
  float* s_z = s_inv + NB;                            // [NB] z_j of the panel's steps
  int* s_ij = reinterpret_cast<int*>(s_z + NB);       // [own] (I << 16) | J
  const size_t sys = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;

  for (int i = tid; i < t; i += kClThreads) {
    const int f = cl_first(i, C, rank);
    const int q0 = cl_row_start(i, m, C, rank);
    for (int jl = f; jl < m; ++jl) s_ij[q0 + jl - f] = (i << 16) | (rank + jl * C);
  }
  for (int c = tid; c < np; c += kClThreads) s_y[c] = c < n ? b[sys * n + c] : 0.f;
  // its tiles of the upper triangle, a warp a row, as on the blocked path
  const float* a_g = a + sys * n * n;
  for (int r = warp; r < np; r += kWarps) {
    const int ti = r / NB;
    const int f = cl_first(ti, C, rank);
    float* row = s_u + static_cast<size_t>(cl_row_start(ti, m, C, rank)) * TF + (r % NB) * NB;
    for (int k = lane; k < (m - f) * NB; k += kWarp) {
      const int c = (rank + (f + k / NB) * C) * NB + k % NB;
      float* dst = row + (k / NB) * TF + k % NB;
      if (c >= r && c < n) {
        copy4(dst, a_g + static_cast<size_t>(r) * n + c);
      } else {
        *dst = r == c ? 1.f : 0.f;
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  cluster.sync();  // every block has started and holds its tiles

  // Panel p, two cluster barriers: the strip (each block its columns right
  // of the panel, L's rows pushed to every block), then the trailing update
  // (each block its tiles) while the owner of panel p + 1 brings that
  // diagonal tile up to date, steps it and pushes its L rows, inv_d and z_j.
  // A block writes another's s_l only in a strip and its s_ld only in a
  // trailing update, and reads each only in the other phase, so one buffer
  // of each does.
  for (int p = -1; p < t; ++p) {
    const int e = (p + 1) * NB;  // the first column right of panel p
    if (p >= 0) {
      // the strip: this block's columns right of the panel, a thread a column
      const int f = cl_first(p + 1, C, rank);
      const int q0 = cl_row_start(p, m, C, rank) + f - cl_first(p, C, rank);
      for (int k = tid; k < (m - f) * NB; k += kClThreads) {
        const int c = (rank + (f + k / NB) * C) * NB + k % NB;
        s_y[c] = blk_strip<NB>(s_u + static_cast<size_t>(q0 + k / NB) * TF + k % NB, s_l + c, np,
                               s_ld, s_inv, s_z, s_y[c]);
        cl_push_column<NB, C>(cluster, rank, s_l + c, np);
      }
      cluster.sync();
    }
    if (p + 1 < t) {
      const bool mine = (p + 1) % C == rank;
      const int qd = cl_row_start(p + 1, m, C, rank);  // the next diagonal tile, if mine
      if (mine && warp == 0) {
        const int me = lane_id();
        const int rg = me / G, cg = me % G;
        if (p >= 0 && me < G * G && rg <= cg) {
          blk_update4<NB>(s_u + static_cast<size_t>(qd) * TF + 4 * rg * NB + 4 * cg,
                          s_l + e + 4 * rg, s_l + e + 4 * cg, np, rg == cg);
        }
        __syncwarp();
        blk_panel<NB>(s_u + static_cast<size_t>(qd) * TF, s_y + e, s_ld, s_inv, s_z, lane);
        __syncwarp();
        cl_push_panel<NB, C>(cluster, rank, s_ld, lane);
      } else if (p >= 0) {
        // the trailing update: this block's tiles below the panel, a 4 x 4
        // register tile a thread (the next diagonal tile is its owner's warp 0's)
        const int first = mine ? qd + 1 : qd;
        const int lead = mine ? kWarp : 0;
        const int count = (own - first) * G * G;
        for (int f = tid - lead; f < count; f += kClThreads - lead) {
          const int q = first + f / (G * G);
          const int rg = f / G % G, cg = f % G;
          const int ij = s_ij[q];
          const int ti = ij >> 16, tj = ij & 0xffff;
          if (ti == tj && rg > cg) continue;  // below the diagonal
          blk_update4<NB>(s_u + static_cast<size_t>(q) * TF + 4 * rg * NB + 4 * cg,
                          s_l + ti * NB + 4 * rg, s_l + tj * NB + 4 * cg, np,
                          ti == tj && rg == cg);
        }
      }
    }
    cluster.sync();
  }

  // Back substitution by panels from the last, one cluster barrier a panel:
  // the owner of panel p takes panel p + 1's x off the panel's rows and
  // solves it on warp 0, with that x pushed into its memory by the owner of
  // panel p + 1 and its lanes' rows of tile (p, p + 1) read from that block
  // a panel ahead, so that nothing remote waits in the chain; meanwhile the
  // owner of panel p + 1, whose column those tiles are, takes that x off
  // every row above panel p, each y_r in the block of its segment. Each y_r
  // takes its x_j with j descending, as on the wide path. L's buffer holds x.
  float* s_x = s_l;
  float urem[NB];  // warp 0 of the owner of panel p: its lane's row of tile (p, p + 1)
  for (int p = t - 1; p >= 0; --p) {
    const int s = p * NB;
    const int e = s + NB;
    const int next = (p + 1) % C;
    if (p % C == rank && warp == 0) {
      const float* diag = s_u + static_cast<size_t>(cl_row_start(p, m, C, rank)) * TF;
      float urow[NB];
#pragma unroll
      for (int g = 0; g < NB / 4; ++g) load4(diag + (lane % NB) * NB, g, urow + 4 * g);
      float yv = lane < NB ? s_y[s + lane] : 0.f;
      const float d = lane < NB ? diag[lane * (NB + 1)] : 0.f;
      const float dinv = d > 0.f ? 1.f / d : 0.f;
      if (p + 1 < t && lane < NB) {
        float xv[NB];
#pragma unroll
        for (int g = 0; g < NB / 4; ++g) load4(s_x + e, g, xv + 4 * g);
#pragma unroll
        for (int j = NB - 1; j >= 0; --j) yv = __fmaf_rn(-urem[j], xv[j], yv);
      }
      float xs = 0.f;
#pragma unroll
      for (int j = NB - 1; j >= 0; --j) {
        const float xj = __shfl_sync(kFull, yv * dinv, j);
        if (lane == j) xs = xj;
        if (lane < j) yv = __fmaf_rn(-urow[j], xj, yv);
      }
      if (lane < NB) {
        s_x[s + lane] = xs;
        if (p > 0) *cluster.map_shared_rank(s_x + s + lane, (p - 1) % C) = xs;
        if (s + lane < n) x[sys * n + s + lane] = xs;
      }
    } else if (next == rank && p + 1 < t) {
      for (int r = tid; r < s; r += kClThreads) {
        const int ti = r / NB;
        float* yr = cluster.map_shared_rank(s_y, ti % C) + r;
        *yr = take_panel<NB>(s_u + static_cast<size_t>(cl_tile(ti, p + 1, m, C, rank)) * TF +
                                 (r % NB) * NB,
                             s_x + e, *yr);
      }
    }
    if (p > 0 && (p - 1) % C == rank && warp == 0) {  // the next panel's owner reads ahead
      const int o = p % C;
      const float* tile = cluster.map_shared_rank(s_u, o) +
                          static_cast<size_t>(cl_tile(p - 1, p, cl_cols(t, C, o), C, o)) * TF;
#pragma unroll
      for (int g = 0; g < NB / 4; ++g) load4(tile + (lane % NB) * NB, g, urem + 4 * g);
    }
    cluster.sync();  // and no block leaves while another may use its memory
  }
}

// The launch of a cluster of C blocks a system (cudaLaunchKernelEx with
// the cluster-dimension attribute), or the config the occupancy query asks
// about; the kernel's shared memory opt-in first.
template <int C>
cudaError_t cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int blocks,
                           int smem, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      spd_cluster_kernel<kBlkNb, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(kClThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int C>
cudaError_t launch_cluster(const float* a, const float* b, float* x, int blocks, int n, int t,
                           int tmax, int smem, cudaStream_t st) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<C>(&cfg, &attr, blocks, smem, st);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, spd_cluster_kernel<kBlkNb, C>, a, b, x, n, t, tmax);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int C>
cudaError_t cluster_occupancy(int smem, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t err = cluster_config<C>(&cfg, &attr, C, smem, nullptr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(out, spd_cluster_kernel<kBlkNb, C>, &cfg);
}

// ---- the tiled path (the cluster ceiling < n <= kWideMaxN) ----------------
constexpr int kTlThreads = 256;   // threads of the copy and back-substitution blocks
constexpr int kTlStripThreads = 128;  // threads (columns) of a strip block: three blocks an SM
constexpr int kTlSub = kWarp;     // back substitution's sub-panel: one warp's rows
constexpr int kTlNb = 64;         // the tile width: a panel's columns
// the kernels of a call, in the order of the plan's threads: the copy, the
// diagonal tile, the strip, the trailing update, back substitution
enum TlKernel { kTlCopy, kTlDiag, kTlStrip, kTlUpdate, kTlBack, kTlKernels };

// threads a block of each kernel at tile width nb: the trailing update
// takes a 4 x 4 register tile a thread, the diagonal tile one warp
__host__ __device__ constexpr int tl_threads(int kernel, int nb) {
  return kernel == kTlDiag     ? kWarp
         : kernel == kTlUpdate ? (nb / 4) * (nb / 4)
         : kernel == kTlStrip  ? kTlStripThreads
                               : kTlThreads;
}
// One system's working copy, floats: the tiles (I <= J, row-major over the
// upper triangle, each nb x nb row-major), y [t nb], L's rows of the
// current panel [nb][t nb] (back substitution's x at the end), then the
// panel's diagonal L rows [nb][nb], inv_d [nb] and z_j [nb]. Every part
// starts at a multiple of 32 floats.
__host__ __device__ constexpr long long tl_system_floats(int t, int nb) {
  return blk_tiles(t) * nb * nb + static_cast<long long>(t) * nb * (1 + nb) + nb * nb + 2LL * nb;
}

struct TlSystem {
  float* u;   // the tiles
  float* y;   // [t nb]
  float* l;   // [nb][t nb]
  float* ld;  // [nb][nb], then inv_d [nb] and z_j [nb]
};
__device__ __forceinline__ TlSystem tl_system(float* w, long long sys, int t, int nb) {
  TlSystem s;
  s.u = w + sys * tl_system_floats(t, nb);
  s.y = s.u + blk_tiles(t) * nb * nb;
  s.l = s.y + static_cast<long long>(t) * nb;
  s.ld = s.l + static_cast<long long>(t) * nb * nb;
  return s;
}
// tile (i, j) of a system, i <= j
__device__ __forceinline__ float* tl_tile(const TlSystem& s, int i, int j, int t, int nb) {
  return s.u + static_cast<long long>(blk_tile(i, j, t)) * nb * nb;
}

// One 16-byte copy from device memory into shared memory (cp.async, L2 only).
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(src) : "memory");
}

// A 32-wide sub-panel of a diagonal tile (row-major at `tile` with row
// pitch P, U's rows; L's rows into s_ld at the same pitch) on one warp,
// lane c on column c (rows 0..c held in registers): the TPU kernel's 32
// right-looking steps. Step j publishes L's row j (l_c, 0 left of j) to
// s_ld, and its inv_d and z_j; every lane reads the m_r of its updates from
// that row in 16-byte broadcasts (m_j = l_j - 1), and the next pivot comes
// from its owner's own l (m_{j+1} = l_{j+1}: the bits of its row update) by
// one shuffle. Rows below a lane's column are never written back. The
// rows go back (row j as updated by step j, which back substitution
// reads), and y's segment to yseg. Not inlined: the diagonal kernel calls
// it twice, and its unrolled steps are long.
template <int P>
__device__ __noinline__ void tl_diag(float* tile, float* yseg, float* s_ld, float* s_inv,
                                     float* s_z, int lane) {
  float col[kWarp];
#pragma unroll
  for (int r = 0; r < kWarp; ++r) col[r] = r <= lane ? tile[r * P + lane] : 0.f;
  float yv = yseg[lane];
  float d2 = __shfl_sync(kFull, col[0], 0);
#pragma unroll
  for (int j = 0; j < kWarp; ++j) {
    const float inv_d = d2 > 0.f ? rsqrtf(d2) : 0.f;
    const float zj = __shfl_sync(kFull, yv, j) * inv_d;
    const float l = lane >= j ? col[j] * inv_d : 0.f;
    s_ld[j * P + lane] = l;
    if (lane == 0) s_inv[j] = inv_d, s_z[j] = zj;
    if (j + 1 < kWarp) d2 = __shfl_sync(kFull, __fmaf_rn(-l, l, col[j + 1]), j + 1);
    __syncwarp();
#pragma unroll
    for (int g = j / 4; g < kWarp / 4; ++g) {
      float m[4];
      load4(s_ld + j * P, g, m);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * g + i;
        if (r >= j) col[r] = __fmaf_rn(-(r == j ? m[i] - 1.f : m[i]), l, col[r]);
      }
    }
    if (lane >= j) yv = __fmaf_rn(-(lane == j ? l - 1.f : l), zj, yv);
  }
#pragma unroll
  for (int r = 0; r < kWarp; ++r) {
    if (r <= lane) tile[r * P + lane] = col[r];
  }
  yseg[lane] = yv;
}

// One strip column c of a panel (its NB rows at tcol, row pitch NB): the
// panel's NB steps against the diagonal tile's L rows (s_ld), l_c of step j
// = U[j][c] * inv_d into L's buffer (lcol, row pitch np), y_c = fma(-l_c,
// z_j, y_c); blk_strip's arithmetic, each row of s_ld read 16 bytes at a
// time as it is used.
template <int NB>
__device__ __forceinline__ float tl_strip(float* __restrict__ tcol, float* __restrict__ lcol,
                                          int np, const float* __restrict__ s_ld,
                                          const float* __restrict__ s_inv,
                                          const float* __restrict__ s_z, float yc) {
  float col[NB];
#pragma unroll
  for (int r = 0; r < NB; ++r) col[r] = tcol[r * NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const float lc = col[j] * s_inv[j];
    lcol[j * np] = lc;
#pragma unroll
    for (int g = j / 4; g < NB / 4; ++g) {
      float m[4];
      load4(s_ld + j * NB, g, m);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * g + i;
        if (r >= j) col[r] = __fmaf_rn(-(r == j ? m[i] - 1.f : m[i]), lc, col[r]);
      }
    }
    yc = __fmaf_rn(-lc, s_z[j], yc);
  }
#pragma unroll
  for (int r = 0; r < NB; ++r) tcol[r * NB] = col[r];
  return yc;
}

// The copy: one block a (system, tile (I, J)). The tile's part of A's upper
// triangle, the padding the identity and the part of a diagonal tile below
// its diagonal 0 (never read); a diagonal tile's block also copies y's
// segment (b, 0 in the padding). A is never written and its lower triangle
// never read.
template <int NB>
__global__ void __launch_bounds__(kTlThreads)
spd_tiled_copy_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ w, int n, int t) {
  const int tiles = t * (t + 1) / 2;
  const long long sys = blockIdx.x / tiles;
  const int q = blockIdx.x % tiles;
  int i = 0, r = q;
  while (r >= t - i) r -= t - i++;
  const int j = i + r;
  const TlSystem s = tl_system(w, sys, t, NB);
  float* tile = s.u + static_cast<long long>(q) * NB * NB;
  const float* a_g = a + sys * n * n;
  for (int e = threadIdx.x; e < NB * NB; e += kTlThreads) {
    const int row = i * NB + e / NB, c = j * NB + e % NB;
    tile[e] = c >= row && c < n ? a_g[static_cast<long long>(row) * n + c] : (row == c ? 1.f : 0.f);
  }
  if (i == j) {
    for (int c = threadIdx.x; c < NB; c += kTlThreads) {
      s.y[i * NB + c] = i * NB + c < n ? b[sys * n + i * NB + c] : 0.f;
    }
  }
}

// Panel p's diagonal tile, one warp a system, as 2 x 2 sub-tiles of 32, so
// that the unrolled code stays short: sub-tile (0, 0)'s steps (tl_diag), the
// strip of its rows over columns 32..63 (lane c on column 32 + c, its l
// kept), the rank-32 update of sub-tile (1, 1), then that sub-tile's steps;
// every element takes the FMAs of the NB steps in their order. Its L rows,
// inv_d and z_j then go to the system's diagonal buffer for the strip.
template <int NB>
__global__ void __launch_bounds__(kWarp)
spd_tiled_diag_kernel(float* __restrict__ w, int t, int p) {
  __shared__ __align__(16) float s_d[NB * NB + 2 * NB];  // L rows, inv_d, z_j
  const TlSystem s = tl_system(w, blockIdx.x, t, NB);
  const int lane = threadIdx.x;
  float* tile = tl_tile(s, p, p, t, NB);
  float* yseg = s.y + p * NB;
  float* s_inv = s_d + NB * NB;
  float* s_z = s_inv + NB;
  static_assert(NB == 2 * kWarp, "the diagonal tile is two sub-panels of a warp's width");
  constexpr int H = kWarp;
  tl_diag<NB>(tile, yseg, s_d, s_inv, s_z, lane);
  __syncwarp();
  float col[H], lcs[H];
#pragma unroll
  for (int r = 0; r < H; ++r) col[r] = tile[r * NB + H + lane];
  float yc = yseg[H + lane];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float lc = col[j] * s_inv[j];
    lcs[j] = lc;
    s_d[j * NB + H + lane] = lc;
#pragma unroll
    for (int g = j / 4; g < H / 4; ++g) {
      float m[4];
      load4(s_d + j * NB, g, m);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * g + i;
        if (r >= j) col[r] = __fmaf_rn(-(r == j ? m[i] - 1.f : m[i]), lc, col[r]);
      }
    }
    yc = __fmaf_rn(-lc, s_z[j], yc);
  }
#pragma unroll
  for (int r = 0; r < H; ++r) tile[r * NB + H + lane] = col[r];
  yseg[H + lane] = yc;
  __syncwarp();
  float u[H];
#pragma unroll
  for (int r = 0; r < H; ++r) u[r] = r <= lane ? tile[(H + r) * NB + H + lane] : 0.f;
#pragma unroll
  for (int k = 0; k < H; ++k) {
#pragma unroll
    for (int g = 0; g < H / 4; ++g) {
      float lr[4];
      load4(s_d + k * NB + H, g, lr);
#pragma unroll
      for (int i = 0; i < 4; ++i) u[4 * g + i] = __fmaf_rn(-lr[i], lcs[k], u[4 * g + i]);
    }
  }
#pragma unroll
  for (int r = 0; r < H; ++r) {
    if (r <= lane) tile[(H + r) * NB + H + lane] = u[r];
  }
  __syncwarp();
  tl_diag<NB>(tile + H * NB + H, yseg + H, s_d + H * NB + H, s_inv + H, s_z + H, lane);
  __syncwarp();
  for (int e = 4 * lane; e < NB * NB + 2 * NB; e += 4 * kWarp) {
    *reinterpret_cast<float4*>(s.ld + e) = *reinterpret_cast<const float4*>(s_d + e);
  }
}

// Panel p's strip: the columns right of the panel, a thread a column
// (tl_strip), per_sys blocks a system; y right of the panel with them. The
// column's NB rows in registers (144 at nb = 64) allow one block of 256 an
// SM, so a block takes 128 columns: three an SM.
template <int NB>
__global__ void __launch_bounds__(kTlStripThreads)
spd_tiled_strip_kernel(float* __restrict__ w, int t, int p, int per_sys) {
  __shared__ __align__(16) float s_d[NB * NB + 2 * NB];
  const long long sys = blockIdx.x / per_sys;
  const int sb = blockIdx.x % per_sys;
  const TlSystem s = tl_system(w, sys, t, NB);
  for (int e = 4 * threadIdx.x; e < NB * NB + 2 * NB; e += 4 * kTlStripThreads) {
    copy16(s_d + e, s.ld + e);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const int np = t * NB;
  const int c = (p + 1) * NB + sb * kTlStripThreads + static_cast<int>(threadIdx.x);
  if (c < np) {
    s.y[c] = tl_strip<NB>(tl_tile(s, p, c / NB, t, NB) + c % NB, s.l + c, np, s_d, s_d + NB * NB,
                          s_d + NB * NB + NB, s.y[c]);
  }
}

// Panel p's trailing update: one block a (system, tile (I, J), p < I <=
// J), per_sys tiles a system in row-major order. L's rows of the panel at
// the tile's rows and columns are copied into shared memory; a thread takes
// one 4 x 4 register tile, k over the panel's steps ascending
// (blk_update4); a diagonal tile keeps its upper part.
template <int NB>
__global__ void __launch_bounds__((NB / 4) * (NB / 4))
spd_tiled_update_kernel(float* __restrict__ w, int t, int p, int per_sys) {
  constexpr int G = NB / 4;
  constexpr int T = G * G;
  __shared__ __align__(16) float s_li[NB * NB];
  __shared__ __align__(16) float s_lj[NB * NB];
  const long long sys = blockIdx.x / per_sys;
  int f = blockIdx.x % per_sys;
  int i = p + 1;
  while (f >= t - i) f -= t - i++;
  const int j = i + f;
  const TlSystem s = tl_system(w, sys, t, NB);
  const int np = t * NB;
  const int tid = threadIdx.x;
  for (int e = tid; e < NB * G; e += T) {
    const int k = e / G, g = e % G;
    copy16(s_li + k * NB + 4 * g, s.l + k * np + i * NB + 4 * g);
    if (i != j) copy16(s_lj + k * NB + 4 * g, s.l + k * np + j * NB + 4 * g);
  }
  const int rg = tid / G, cg = tid % G;
  float* tu = tl_tile(s, i, j, t, NB) + 4 * rg * NB + 4 * cg;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) load4(tu + r * NB, 0, acc[r]);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (i == j && rg > cg) return;  // below the diagonal
  const float* lr = s_li + 4 * rg;
  const float* lc = (i == j ? s_li : s_lj) + 4 * cg;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    float rv[4], cv[4];
    load4(lr + k * NB, 0, rv);
    load4(lc + k * NB, 0, cv);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = __fmaf_rn(-rv[r], cv[c], acc[r][c]);
    }
  }
  if (i == j && rg == cg) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = r; c < 4; ++c) tu[r * NB + c] = acc[r][c];
    }
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      *reinterpret_cast<float4*>(tu + r * NB) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
}

// Back substitution, one block a system, by sub-panels of kTlSub rows from
// the last, one barrier a sub-panel: warp 0 takes sub-panel q + 1's x off
// the rows of sub-panel q and then solves it, x_j = y_j * (d > 0 ? 1/d :
// 0) with j descending, lane r on row r; meanwhile the other warps take
// sub-panel q + 1's x off every row above sub-panel q. Each y_r takes its
// x_j with j descending, as on the wide path. x goes to L's buffer (padded)
// and to the output.
template <int NB>
__global__ void __launch_bounds__(kTlThreads)
spd_tiled_back_kernel(float* __restrict__ w, float* __restrict__ x, int n, int t) {
  const long long sys = blockIdx.x;
  const TlSystem s = tl_system(w, sys, t, NB);
  const int np = t * NB;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp, warp = tid / kWarp;
  float* xp = s.l;
  for (int q = np / kTlSub - 1; q >= 0; --q) {
    const int s0 = q * kTlSub;
    const int e = s0 + kTlSub;
    if (warp == 0) {
      const int row = s0 + lane;
      const float* urow = tl_tile(s, row / NB, s0 / NB, t, NB) + (row % NB) * NB + s0 % NB;
      float u[kTlSub];
#pragma unroll
      for (int g = 0; g < kTlSub / 4; ++g) load4(urow, g, u + 4 * g);
      float yv = s.y[row];
      const float d = urow[lane];
      const float dinv = d > 0.f ? 1.f / d : 0.f;
      if (e < np) {
        yv = take_panel<kTlSub>(tl_tile(s, row / NB, e / NB, t, NB) + (row % NB) * NB + e % NB,
                                xp + e, yv);
      }
      float xs = 0.f;
#pragma unroll
      for (int j = kTlSub - 1; j >= 0; --j) {
        const float xj = __shfl_sync(kFull, yv * dinv, j);
        if (lane == j) xs = xj;
        if (lane < j) yv = __fmaf_rn(-u[j], xj, yv);
      }
      xp[row] = xs;
      if (row < n) x[sys * n + row] = xs;
    } else if (e < np) {
      for (int r = tid - kWarp; r < s0; r += kTlThreads - kWarp) {
        s.y[r] = take_panel<kTlSub>(tl_tile(s, r / NB, e / NB, t, NB) + (r % NB) * NB + e % NB,
                                    xp + e, s.y[r]);
      }
    }
    __syncthreads();
  }
}

// The launches of one call at t tiles a side and tile width nb, in order,
// each handed to f(kernel, panel, blocks a system): the copy (a block a
// tile); for each panel p its diagonal tile (one warp a system), then, but
// for the last panel, its strip (a block of kTlStripThreads columns) and its
// trailing update (a block a tile right of and below the panel); back
// substitution (a block a system). 3t launches.
template <class F>
void tl_for_each_launch(int t, int nb, F f) {
  const int np = t * nb;
  f(kTlCopy, -1, t * (t + 1) / 2);
  for (int p = 0; p < t; ++p) {
    f(kTlDiag, p, 1);
    if (p + 1 < t) {
      const int m = t - p - 1;
      f(kTlStrip, p, (np - (p + 1) * nb + kTlStripThreads - 1) / kTlStripThreads);
      f(kTlUpdate, p, m * (m + 1) / 2);
    }
  }
  f(kTlBack, -1, 1);
}

template <int NB>
cudaError_t launch_tiled(const float* a, const float* b, float* x, float* w, int B, int n,
                         cudaStream_t st) {
  const int t = (n + NB - 1) / NB;
  cudaError_t err = cudaSuccess;
  tl_for_each_launch(t, NB, [&](int kernel, int p, int per_sys) {
    if (err != cudaSuccess) return;
    const int blocks = B * per_sys;
    const int threads = tl_threads(kernel, NB);
    switch (kernel) {
      case kTlCopy: spd_tiled_copy_kernel<NB><<<blocks, threads, 0, st>>>(a, b, w, n, t); break;
      case kTlDiag: spd_tiled_diag_kernel<NB><<<blocks, threads, 0, st>>>(w, t, p); break;
      case kTlStrip:
        spd_tiled_strip_kernel<NB><<<blocks, threads, 0, st>>>(w, t, p, per_sys);
        break;
      case kTlUpdate:
        spd_tiled_update_kernel<NB><<<blocks, threads, 0, st>>>(w, t, p, per_sys);
        break;
      default: spd_tiled_back_kernel<NB><<<blocks, threads, 0, st>>>(w, x, n, t); break;
    }
    err = cudaGetLastError();
  });
  return err;
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

// Launches the blocked path (kMaxN < n, as long as its shared memory fits)
// on `stream` and returns cudaGetLastError() (0 = ok). Device pointers as
// pio_spd_solve's. The plan: the tile width nb, threads a block, tiles of the
// upper triangle (t(t+1)/2 at t = ceil(n / nb)), blocks (= B) and dynamic
// shared memory in bytes; a plan that does not match this arithmetic is
// refused (cudaErrorInvalidValue).
extern "C" int pio_spd_solve_blocked(const void* a, const void* b, void* x, int B,
                                     int n, int nb, int threads, int tiles,
                                     int blocks, int smem, void* stream) {
  if (B < 1 || n <= kMaxN || n > kWideMaxN || nb != kBlkNb || threads != kBlkThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int t = (n + nb - 1) / nb;
  const long long want = blk_smem_bytes(t, nb);
  if (want > kMaxSmem || tiles != blk_tiles(t) || blocks != B || smem != want) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<size_t>(smem) > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        spd_blocked_kernel<kBlkNb>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  spd_blocked_kernel<kBlkNb><<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(x), n, t);
  return static_cast<int>(cudaGetLastError());
}

// Launches the cluster path (kMaxN < n, as long as the largest block's share
// fits in shared memory) on `stream` and returns its first error (0 = ok; a
// cluster launch the card refuses is an error). Device pointers as
// pio_spd_solve's. The plan: the tile width nb, threads a block, blocks a
// cluster (2, 4 or 8), the largest block's tiles at t = ceil(n / nb), blocks
// (= B * cluster) and dynamic shared memory in bytes; a plan that does not
// match this arithmetic is refused (cudaErrorInvalidValue).
extern "C" int pio_spd_solve_cluster(const void* a, const void* b, void* x, int B, int n,
                                     int nb, int threads, int cluster, int tiles, int blocks,
                                     int smem, void* stream) {
  if (B < 1 || n <= kMaxN || n > kWideMaxN || nb != kBlkNb || threads != kClThreads ||
      (cluster != kClSizes[0] && cluster != kClSizes[1] && cluster != kClSizes[2])) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int t = (n + nb - 1) / nb;
  const long long want = cl_smem_bytes(t, cluster, nb);
  if (want > kMaxSmem || tiles != cl_max_tiles(t, cluster) ||
      blocks != static_cast<long long>(B) * cluster || smem != want) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* xf = static_cast<float*>(x);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (cluster) {
    case 2: err = launch_cluster<2>(af, bf, xf, blocks, n, t, tiles, smem, st); break;
    case 4: err = launch_cluster<4>(af, bf, xf, blocks, n, t, tiles, smem, st); break;
    case 8: err = launch_cluster<8>(af, bf, xf, blocks, n, t, tiles, smem, st); break;
  }
  return static_cast<int>(err);
}

// Clusters of `cluster` blocks with `smem` bytes of dynamic shared memory
// each that the card holds at once (cudaOccupancyMaxActiveClusters), into
// *out. Returns the first error.
extern "C" int pio_spd_solve_cluster_occupancy(int cluster, int smem, int* out) {
  if (smem < 0 || smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  switch (cluster) {
    case 2: return static_cast<int>(cluster_occupancy<2>(smem, out));
    case 4: return static_cast<int>(cluster_occupancy<4>(smem, out));
    case 8: return static_cast<int>(cluster_occupancy<8>(smem, out));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers a thread, local (spilled) bytes and static shared memory of the
// cluster kernel at each cluster size (2, 4, 8), three ints each. Returns the
// first error of cudaFuncGetAttributes.
extern "C" int pio_spd_solve_cluster_attrs(int* out) {
  const void* kernels[] = {
      reinterpret_cast<const void*>(spd_cluster_kernel<kBlkNb, 2>),
      reinterpret_cast<const void*>(spd_cluster_kernel<kBlkNb, 4>),
      reinterpret_cast<const void*>(spd_cluster_kernel<kBlkNb, 8>),
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

// Launches the tiled path (kMaxN < n <= kWideMaxN) on `stream` and returns
// the first error (0 = ok). Device pointers as pio_spd_solve's, plus work
// [B, work_floats] f32, the working copy (tl_system_floats). The plan: the
// tile width nb (kTlNb), tiles of the upper triangle and panels at t =
// ceil(n / nb), the working copy's floats a system, the threads a block of
// each kernel (kernels ints, in TlKernel's order) and the blocks a system of
// each launch (launches ints, in tl_for_each_launch's order); a plan that
// does not match this arithmetic is refused (cudaErrorInvalidValue) before
// anything is launched.
extern "C" int pio_spd_solve_tiled(const void* a, const void* b, void* x, void* work, int B,
                                   int n, int nb, int tiles, int panels, int work_floats,
                                   const int* threads, int kernels, const int* blocks,
                                   int launches, void* stream) {
  if (B < 1 || n <= kMaxN || n > kWideMaxN || nb != kTlNb || kernels != kTlKernels ||
      threads == nullptr || blocks == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int t = (n + nb - 1) / nb;
  bool ok = tiles == blk_tiles(t) && panels == t && work_floats == tl_system_floats(t, nb);
  for (int k = 0; k < kTlKernels; ++k) ok = ok && threads[k] == tl_threads(k, nb);
  int count = 0;
  tl_for_each_launch(t, nb, [&](int, int, int per_sys) {
    ok = ok && count < launches && blocks[count] == per_sys &&
         static_cast<long long>(B) * per_sys <= 0x7fffffffLL;
    ++count;
  });
  if (!ok || count != launches) return static_cast<int>(cudaErrorInvalidValue);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* xf = static_cast<float*>(x);
  float* wf = static_cast<float*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(launch_tiled<kTlNb>(af, bf, xf, wf, B, n, st));
}

// Registers a thread, local (spilled) bytes and static shared memory of the
// tiled path's kernels, three ints each, in TlKernel's order: the copy,
// diagonal, strip, update and back-substitution kernels. Returns the first
// error of cudaFuncGetAttributes.
extern "C" int pio_spd_solve_tiled_attrs(int* out) {
  const void* kernels[] = {
      reinterpret_cast<const void*>(spd_tiled_copy_kernel<kTlNb>),
      reinterpret_cast<const void*>(spd_tiled_diag_kernel<kTlNb>),
      reinterpret_cast<const void*>(spd_tiled_strip_kernel<kTlNb>),
      reinterpret_cast<const void*>(spd_tiled_update_kernel<kTlNb>),
      reinterpret_cast<const void*>(spd_tiled_back_kernel<kTlNb>),
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

// Registers a thread, local (spilled) bytes and static shared memory of every
// solve kernel, three ints each, in this order: the registers kernel at
// np = 8, 16, ..., 64, the shared kernel, the blocked kernel, then the wide kernel. Returns
// the first error of cudaFuncGetAttributes.
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
      reinterpret_cast<const void*>(spd_blocked_kernel<kBlkNb>),
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
