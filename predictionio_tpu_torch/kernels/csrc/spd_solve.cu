// Batched SPD solve (the ALS normal-equation solve), hand-written for Hopper
// (sm_90a).
//
// Replaces predictionio_tpu/ops/pallas_kernels.py::_spd_kernel (the Pallas
// body of spd_solve_t). For each system s it solves a[s] x[s] = b[s] with the
// TPU kernel's algorithm and guard:
//   forward, step j:  d2 = a[j][j];  inv_d = d2 > 0 ? rsqrt(d2) : 0;
//                     l = row j * inv_d  (L's column j; the block is symmetric)
//                     a -= (l - e_j) (x) l  (trailing update; row j now holds l)
//                     z_j = y[j] * inv_d;  y -= (l - e_j) * z_j
//   back, j = n-1..0: d = a[j][j];  inv = d > 0 ? 1/d : 0;
//                     x[j] = (y[j] - sum_{i>j} a[j][i] x[i]) * inv
// so an all-zero system solves to exactly 0 (never NaN), and a zero pivot of a
// singular PSD system gives a zero component instead of a division by zero.
// No Newton-Schulz: it stalls near 1e-2 relative error on ALS systems.
//
// Contract (checked by tests/test_torch_als_kernels.py against the JAX kernel
// and np.linalg.solve, and by chip_smoke.py against the plain PyTorch version
// on the card): a [B, n, n] and b [B, n] f32, batch-major (the layout the
// gramian_fused kernel writes), any B and any n from 1 to kMaxN = 128. The
// TPU kernel's n % 8 and B % 128 rules were Mosaic tiling artefacts.
//
// Design. The TPU kernel puts 128 systems on the vector lanes in an
// [n, n, 128] VMEM block. On the card one warp owns one system, held in
// shared memory (n * n + 2n floats: 10.4 KB at n = 50, 66 KB at the ceiling,
// with the opt-in to more than 48 KB). Lanes own columns: at step j every lane
// updates its columns of each trailing row, so neighbouring lanes touch
// neighbouring words. Only the upper triangle of the trailing block is
// updated; the TPU kernel updates the whole block, but the entries this skips
// are multiplied by exact zeros there (columns left of j were zeroed by their
// own steps), and the trailing block stays exactly symmetric (l_r * l_c =
// l_c * l_r), so the values read are the same. Back substitution reduces each
// row's dot product across the warp with shuffles. All arithmetic is fp32 on
// the CUDA cores.
//
// Bound at the training slice's shapes (138,000 user and 27,000 item systems
// per iteration at n = 50; H100 SXM data sheet: 3.35 TB/s, about 67 TFLOP/s
// fp32): reading A once is B * n^2 * 4 bytes, 1.65 GB per iteration (0.49
// ms), while the solve needs B * (n^3/3 + 2n^2) FLOP, 7.7 GFLOP (0.11 ms):
// bound by bytes, 0.51 ms per iteration with b and x. chip_smoke.py prints
// the bound of each launch beside its time. This first version is written to
// be right: a warp walks its trailing rows one after another, and reading only
// the upper triangle of A (half the bytes) or fusing the solve into the
// build, so A never reaches device memory, is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 128;
constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;  // systems per block
constexpr size_t kDefaultSmem = 48 * 1024;

__global__ void spd_solve_kernel(const float* __restrict__ a,
                                 const float* __restrict__ b,
                                 float* __restrict__ x, int B, int n) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int sys = blockIdx.x * (blockDim.x / kWarp) + warp;
  float* s_a = smem + static_cast<size_t>(warp) * (n * n + 2 * n);
  float* s_y = s_a + n * n;
  float* s_l = s_y + n;  // L's current column, then the solution
  if (sys >= B) return;  // warps share no barrier, so a spare warp may leave

  const float* a_g = a + static_cast<size_t>(sys) * n * n;
  for (int e = lane; e < n * n; e += kWarp) s_a[e] = a_g[e];
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
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
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

}  // namespace

// Launches the solve on `stream` and returns cudaGetLastError() (0 = ok).
// Device pointers: a [B, n, n] f32, b [B, n] f32, x [B, n] f32 (output). The
// caller guarantees B >= 1 and 1 <= n <= 128.
extern "C" int pio_spd_solve(const void* a, const void* b, void* x, int B,
                             int n, void* stream) {
  if (B < 1 || n < 1 || n > kMaxN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t per_warp = static_cast<size_t>(n * n + 2 * n) * sizeof(float);
  int warps = static_cast<int>(kDefaultSmem / per_warp);
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const size_t smem = per_warp * warps;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        spd_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (B + warps - 1) / warps;
  spd_solve_kernel<<<blocks, warps * kWarp, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(x), B, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pio_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
