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
// (ops/cuda_kernels.py::flash_attention_fwd) takes any head width from 1 to
// 128: it zero-pads q, k and v to the next multiple of 8, passes the true width
// for the scale, and slices o back. It raises on anything else.
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
