// Flash attention forward (online softmax, causal or not), hand-written for
// Hopper (sm_90a).
//
// Replaces predictionio_tpu/ops/attention.py::_flash_kernel (:72-124, the body
// of the pl.pallas_call at :145 that flash_attention_pallas reaches). For every
// (batch * head, query row) it computes o = softmax(q k^T / sqrt(D), masked) v
// with the TPU kernel's rules:
//   - q is scaled by 1/sqrt(D) before the dot (the TPU kernel's :83);
//   - under causal a key is kept when q_pos >= k_pos, both counted from 0,
//     also when Lq != Lk; keys at or beyond Lk are masked here (the host pads
//     nothing);
//   - a masked score is the finite -1e30, and the result is o / max(l, 1e-30);
//   - key tiles are walked in ascending order and, under causal, tiles wholly
//     above the query tile's diagonal are skipped (:117-123).
// The ascending order is what keeps the finite mask safe: the running max m
// starts at -1e30, and a row whose first tile held no valid key would add
// exp(0) = 1 to l for every masked key. Tile 0 always holds key 0, which every
// row keeps, so m is a real score after the first tile and every later masked
// key adds exp(-1e30 - m) = 0 exactly.
//
// Contract (checked by tests/test_torch_attention.py against the JAX kernel in
// interpret mode through the plain version, and by chip_smoke.py against the
// plain PyTorch version on the card): q [BH, Lq, D], k and v [BH, Lk, D], o
// [BH, Lq, D], all f32 and contiguous; D a multiple of 8 from 8 to kMaxD = 128;
// Lq, Lk >= 1. The wrapper (ops/cuda_kernels.py::flash_attention_fwd) raises
// on anything else.
//
// Design. One block of kThreads = 256 threads per (batch * head, kTile = 64
// query rows); kGroup = 4 neighbouring threads own one query row. The kernel
// is instantiated for each head width (a template on D / kGroup, the output
// columns a thread owns), so every loop over D is sized at compile time and
// no instruction goes to a column that does not exist. The query tile
// (pre-scaled) and each 64-key K/V tile are staged in shared memory, the Q
// and K rows with a stride of D + 1 floats so that the four threads of a row
// and the eight rows of a warp read distinct banks. A thread scores 16 keys
// of the tile (keys g, g + 4, ...), the group agrees on the tile's max and
// sum with two shuffles, writes its probabilities into a [64, 65] tile, and
// each thread then accumulates its D / 4 output columns over the tile's 64
// keys. The running m, l and output stay in registers in fp32; all
// arithmetic is fp32 on the CUDA cores (no tensor cores: TF32 would miss the
// 2e-4 tolerance, and a 3xTF32 split, wgmma and TMA staging are later work).
// Shared memory: 29 KB at D = 16, 113 KB at D = 128 (with the opt-in above
// 48 KB).
//
// Bound at the slice's shapes (the sequence recommender's training batch: B =
// 64, H = 4, L = 64, D = 16, causal, f32; H100 SXM data sheet: 3.35 TB/s, about
// 67 TFLOP/s fp32): q, k and v read once and o written once are 4.19 MB, 1.25
// us; the causal half of QK^T and PV is 34 MFLOP, 0.5 us. So the bound is set
// by bytes. The design reads each of q, k and v from device memory once per
// (query tile, key tile) pair it visits, which at L = 64 is exactly once, and
// keeps the [L, L] scores out of device memory; what it does not do yet is
// overlap the loads of the next K/V tile with the math of this one.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;    // query rows per block, keys per K/V tile
constexpr int kGroup = 4;    // threads that share one query row
constexpr int kThreads = kTile * kGroup;
constexpr int kMaxD = 128;
constexpr int kKeysPerThread = kTile / kGroup;   // 16
constexpr int kMaxQTiles = 65535;                // grid.y
constexpr float kNegBig = -1e30f;
constexpr size_t kDefaultSmem = 48 * 1024;

// Floats of shared memory for head width d: Q and K tiles [kTile][d + 1],
// the V tile [kTile][d], the probabilities [kTile][kTile + 1].
constexpr size_t smem_floats(int d) {
  return static_cast<size_t>(kTile) * (2 * (d + 1) + d + kTile + 1);
}

// kCols = D / kGroup: the output columns each thread owns (g, g + 4, ...).
template <int kCols>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int Lq, int Lk, int causal, float scale) {
  constexpr int D = kCols * kGroup;
  constexpr int ds = D + 1;
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;              // [kTile][D + 1], pre-scaled
  float* s_k = s_q + kTile * ds;  // [kTile][D + 1]
  float* s_v = s_k + kTile * ds;  // [kTile][D]
  float* s_p = s_v + kTile * D;   // [kTile][kTile + 1]

  const int tid = threadIdx.x;
  const int row = tid / kGroup;  // this thread's query row in the tile
  const int g = tid % kGroup;    // its place in the row's group
  const size_t bh = blockIdx.x;
  const int q_tile = blockIdx.y;
  const int q0 = q_tile * kTile;
  const int q_pos = q0 + row;
  const float* q_bh = q + bh * Lq * D;
  const float* k_bh = k + bh * Lk * D;
  const float* v_bh = v + bh * Lk * D;

  for (int e = tid; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int qr = q0 + r;
    s_q[r * ds + c] = qr < Lq ? q_bh[static_cast<size_t>(qr) * D + c] * scale : 0.f;
  }

  float m = kNegBig, l = 0.f;
  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
  const int n_kv = (Lk + kTile - 1) / kTile;
  // causal: key tiles strictly above this query tile's diagonal are skipped
  const int hi = causal ? min(q_tile + 1, n_kv) : n_kv;
  const float* q_row = s_q + row * ds;
  float* p_row = s_p + row * (kTile + 1);

  for (int j = 0; j < hi; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // Q is staged; the last tile's K, V and P reads are done
    for (int e = tid; e < kTile * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < Lk;
      const size_t off = static_cast<size_t>(k0 + r) * D + c;
      s_k[r * ds + c] = in ? k_bh[off] : 0.f;
      s_v[r * D + c] = in ? v_bh[off] : 0.f;  // 0, never stale: p * NaN = NaN
    }
    __syncthreads();

    float s[kKeysPerThread];
#pragma unroll
    for (int t = 0; t < kKeysPerThread; ++t) s[t] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float qc = q_row[c];
#pragma unroll
      for (int t = 0; t < kKeysPerThread; ++t) {
        s[t] = fmaf(qc, s_k[(g + kGroup * t) * ds + c], s[t]);
      }
    }
    float tile_max = kNegBig;
#pragma unroll
    for (int t = 0; t < kKeysPerThread; ++t) {
      const int k_pos = k0 + g + kGroup * t;
      const bool keep = k_pos < Lk && (!causal || q_pos >= k_pos);
      s[t] = keep ? s[t] : kNegBig;
      tile_max = fmaxf(tile_max, s[t]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int t = 0; t < kKeysPerThread; ++t) {
      const float p = expf(s[t] - m_new);
      p_sum += p;
      p_row[g + kGroup * t] = p;
    }
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 1);
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 2);
    l = l * corr + p_sum;
    m = m_new;
    __syncwarp();  // a row's probabilities are written and read by its group

#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[i] *= corr;
    for (int kk = 0; kk < kTile; ++kk) {
      const float p = p_row[kk];
      const float* v_row = s_v + kk * D + g;
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[i] = fmaf(p, v_row[kGroup * i], acc[i]);
    }
  }

  if (q_pos < Lq) {
    const float denom = fmaxf(l, 1e-30f);
    float* o_row = o + (bh * Lq + q_pos) * D + g;
#pragma unroll
    for (int i = 0; i < kCols; ++i) o_row[kGroup * i] = acc[i] / denom;
  }
}

template <int kCols>
int launch(const float* q, const float* k, const float* v, float* o, int BH,
           int Lq, int Lk, int causal, cudaStream_t stream) {
  constexpr int D = kCols * kGroup;
  constexpr size_t smem = smem_floats(D) * sizeof(float);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<kCols>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(BH, (Lq + kTile - 1) / kTile);
  flash_attention_kernel<kCols><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, Lq, Lk, causal, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the forward on `stream` and returns cudaGetLastError() (0 = ok).
// Device pointers: q [BH, Lq, D], k and v [BH, Lk, D], o [BH, Lq, D] (output),
// all f32 and contiguous. The caller guarantees BH, Lq, Lk >= 1, D a multiple
// of 8 from 8 to 128, and at most 65,535 query tiles of 64 rows.
extern "C" int pio_flash_attention(const void* q, const void* k, const void* v,
                                   void* o, int BH, int Lq, int Lk, int D,
                                   int causal, void* stream) {
  const int q_tiles = (Lq + kTile - 1) / kTile;
  if (BH < 1 || Lq < 1 || Lk < 1 || D < 8 || D > kMaxD || D % 8 != 0 ||
      q_tiles > kMaxQTiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = causal != 0;
  switch (D / kGroup) {
#define PIO_FLASH_COLS(n) \
  case n:                 \
    return launch<n>(qf, kf, vf, of, BH, Lq, Lk, c, s);
    PIO_FLASH_COLS(2) PIO_FLASH_COLS(4) PIO_FLASH_COLS(6) PIO_FLASH_COLS(8)
    PIO_FLASH_COLS(10) PIO_FLASH_COLS(12) PIO_FLASH_COLS(14) PIO_FLASH_COLS(16)
    PIO_FLASH_COLS(18) PIO_FLASH_COLS(20) PIO_FLASH_COLS(22) PIO_FLASH_COLS(24)
    PIO_FLASH_COLS(26) PIO_FLASH_COLS(28) PIO_FLASH_COLS(30) PIO_FLASH_COLS(32)
#undef PIO_FLASH_COLS
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* pio_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
