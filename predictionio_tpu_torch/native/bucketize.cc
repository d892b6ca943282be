// Degree-bucketed COO -> padded-CSR scatter and per-row index sort
// (training infeed hot path, host side).
//
// Native counterpart of the numpy bucketize and sort_bucket_indices in
// ops/als.py (same output contract, bit-identical arrays): the reference
// delegates this shaping to
// Spark MLlib's ALS block partitioner (inside ALS.train, invoked from e.g.
// examples/scala-parallel-recommendation/.../ALSAlgorithm.scala:56-62);
// here it is a two-pass threaded scatter:
//
//   pass A: per-thread row-degree histograms over disjoint nnz ranges
//   prefix: per-(thread,row) write bases so every element's slot is a pure
//           function of (thread, arrival order) -> fully parallel AND
//           deterministic pass B (no atomics, no sort)
//   pass B: scatter cols/vals straight into the caller-allocated padded
//           bucket slabs; elements beyond a row's bucket width are dropped
//           (same truncation rule as the numpy path)
//
// The validity mask is NOT materialized here: it is a pure function of the
// per-row count (prefix-form by construction), which the Python side keeps
// as a [B] int32 array and the device solve re-expands for free. Column
// indices write as uint16 when the opposite-side id space fits (halves the
// largest slab's bytes both in host fill and host->device transfer).
//
// The numpy path costs an O(nnz log nnz) argsort; this is O(nnz) with
// sequential writes per thread in pass A and per-row locality in pass B.
//
// Python allocates all outputs (numpy owns the memory); this file only
// fills them. Buckets and slot assignments are computed in numpy (cheap,
// O(n_rows)) and passed down.
//
// pio_sort_rows then orders each row's valid prefix of (idx, val) pairs by
// idx, stably and in place, so the device build reads neighbouring factor rows
// together. Every (idx, position) pair packs into one distinct 64-bit key,
// so an unstable sort of the keys is the stable sort of the pairs: the
// result is a pure function of the row, whatever the thread count.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// Pass-B scatter body, instantiated per idx element type. `base` carries
// the per-(thread,row) write offsets computed by the histogram prefix.
template <class IdxT>
void scatter_range(const int32_t* rows, const int32_t* cols,
                   const float* vals, int64_t lo, int64_t hi,
                   std::vector<int32_t>& base, const int32_t* bucket_of,
                   const int32_t* slot_of, const int32_t* widths,
                   void** idx_ptrs, float** val_ptrs) {
  for (int64_t k = lo; k < hi; ++k) {
    const int32_t r = rows[k];
    const int32_t w = base[static_cast<size_t>(r)]++;
    const int32_t b = bucket_of[r];
    const int32_t width = widths[b];
    if (w >= width) continue;  // truncated tail of an over-wide row
    const int64_t off = static_cast<int64_t>(slot_of[r]) * width + w;
    static_cast<IdxT*>(idx_ptrs[b])[off] = static_cast<IdxT>(cols[k]);
    val_ptrs[b][off] = vals[k];
  }
}

// The host's threads, at most 16 (4 where the count is unknown).
int max_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n > 16 ? 16 : n);
}

int hardware_threads(int64_t n_rows) {
  int t = max_threads();
  // Pass A allocates one n_rows int32 histogram per thread; bound the
  // total at ~512 MB so huge row spaces degrade to fewer threads instead
  // of O(n_rows x threads) memory blow-up.
  const int64_t budget = 512ll << 20;
  int64_t per_thread = n_rows * 4;
  if (per_thread > 0 && per_thread * t > budget) {
    t = static_cast<int>(std::max<int64_t>(1, budget / per_thread));
  }
  return t;
}

// One row of pio_sort_rows: the first n pairs sorted by idx (stable), in
// place; the padding after them is not touched. keys/vals are scratch of
// at least n entries.
template <class IdxT>
void sort_row(IdxT* idx, float* val, int64_t n, std::vector<uint64_t>& keys,
              std::vector<float>& vals) {
  for (int64_t j = 0; j < n; ++j) {
    keys[j] = (static_cast<uint64_t>(static_cast<uint32_t>(idx[j])) << 32) |
              static_cast<uint64_t>(j);
  }
  std::sort(keys.begin(), keys.begin() + n);
  for (int64_t j = 0; j < n; ++j) vals[j] = val[keys[j] & 0xFFFFFFFFull];
  for (int64_t j = 0; j < n; ++j) {
    idx[j] = static_cast<IdxT>(keys[j] >> 32);
    val[j] = vals[j];
  }
}

template <class IdxT>
void sort_rows(void* idx_slab, float* val_slab, const int32_t* counts,
               int64_t n_rows, int64_t width, int nthreads) {
  IdxT* idx = static_cast<IdxT*>(idx_slab);
  // rows are handed out in blocks from a shared counter: the widest
  // bucket holds a few very long rows, so static ranges would idle threads
  const int64_t block = std::max<int64_t>(1, std::min<int64_t>(64, (1 << 16) / width));
  std::atomic<int64_t> next(0);
  std::vector<std::thread> ts;
  ts.reserve(static_cast<size_t>(nthreads));
  for (int t = 0; t < nthreads; ++t) {
    ts.emplace_back([&]() {
      std::vector<uint64_t> keys(static_cast<size_t>(width));
      std::vector<float> vals(static_cast<size_t>(width));
      for (;;) {
        const int64_t lo = next.fetch_add(block);
        if (lo >= n_rows) break;
        const int64_t hi = std::min<int64_t>(n_rows, lo + block);
        for (int64_t r = lo; r < hi; ++r) {
          sort_row<IdxT>(idx + r * width, val_slab + r * width, counts[r],
                         keys, vals);
        }
      }
    });
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// The most threads either entry point starts (the fill takes fewer when
// its per-thread histograms would pass their memory budget).
int32_t pio_native_threads() { return max_threads(); }

// idx/val: [n_rows * width] row-major slabs (uint16 when idx_u16 else
//   int32 / float32), sorted in place.
// counts: [n_rows] int32, each in [0, width] -- the valid prefix of a row.
// Returns 0 on success, -1 on a count outside [0, width] (nothing written).
int pio_sort_rows(void* idx, float* val, const int32_t* counts,
                  int64_t n_rows, int64_t width, int32_t idx_u16) {
  for (int64_t r = 0; r < n_rows; ++r) {
    if (counts[r] < 0 || counts[r] > width) return -1;
  }
  if (n_rows == 0 || width == 0) return 0;
  int nthreads = max_threads();
  if (n_rows * width < (1 << 15)) nthreads = 1;
  nthreads = static_cast<int>(std::min<int64_t>(nthreads, n_rows));
  if (idx_u16) {
    sort_rows<uint16_t>(idx, val, counts, n_rows, width, nthreads);
  } else {
    sort_rows<int32_t>(idx, val, counts, n_rows, width, nthreads);
  }
  return 0;
}

// rows/cols: [nnz] int32, vals: [nnz] float32.
// bucket_of: [n_rows] int32 -- bucket index per row id (every row with
//   degree > 0 has one; rows absent from the data never appear in `rows`).
// slot_of: [n_rows] int32 -- row's position within its bucket.
// widths: [n_buckets] int32.
// idx_ptrs/val_ptrs: [n_buckets] pointers to zero-initialized slabs of
//   shape [B_b * widths[b]] (uint16 when idx_u16 else int32 / float32).
// idx_u16: nonzero when column ids fit uint16 and the idx slabs are
//   uint16 (caller guarantees max col id <= 0xFFFF).
// Returns 0 on success.
int pio_bucketize_fill(const int32_t* rows, const int32_t* cols,
                       const float* vals, int64_t nnz, int64_t n_rows,
                       const int32_t* bucket_of, const int32_t* slot_of,
                       const int32_t* widths, int32_t n_buckets,
                       void** idx_ptrs, float** val_ptrs, int32_t idx_u16) {
  (void)n_buckets;
  const int nthreads = hardware_threads(n_rows);
  const int64_t chunk = (nnz + nthreads - 1) / nthreads;

  // pass A: per-thread degree histograms over [t*chunk, (t+1)*chunk)
  std::vector<std::vector<int32_t>> hist(static_cast<size_t>(nthreads));
  {
    std::vector<std::thread> ts;
    ts.reserve(static_cast<size_t>(nthreads));
    for (int t = 0; t < nthreads; ++t) {
      ts.emplace_back([&, t]() {
        auto& h = hist[static_cast<size_t>(t)];
        h.assign(static_cast<size_t>(n_rows), 0);
        const int64_t lo = t * chunk;
        const int64_t hi = std::min<int64_t>(nnz, lo + chunk);
        for (int64_t k = lo; k < hi; ++k) ++h[static_cast<size_t>(rows[k])];
      });
    }
    for (auto& th : ts) th.join();
  }

  // prefix over threads: hist[t][r] becomes the within-row write base for
  // thread t (number of row-r elements in threads < t)
  for (int64_t r = 0; r < n_rows; ++r) {
    int32_t acc = 0;
    for (int t = 0; t < nthreads; ++t) {
      int32_t c = hist[static_cast<size_t>(t)][static_cast<size_t>(r)];
      hist[static_cast<size_t>(t)][static_cast<size_t>(r)] = acc;
      acc += c;
    }
  }

  // pass B: deterministic parallel scatter into the padded slabs
  {
    std::vector<std::thread> ts;
    ts.reserve(static_cast<size_t>(nthreads));
    for (int t = 0; t < nthreads; ++t) {
      ts.emplace_back([&, t]() {
        auto& base = hist[static_cast<size_t>(t)];
        const int64_t lo = t * chunk;
        const int64_t hi = std::min<int64_t>(nnz, lo + chunk);
        if (idx_u16) {
          scatter_range<uint16_t>(rows, cols, vals, lo, hi, base,
                                  bucket_of, slot_of, widths, idx_ptrs,
                                  val_ptrs);
        } else {
          scatter_range<int32_t>(rows, cols, vals, lo, hi, base,
                                 bucket_of, slot_of, widths, idx_ptrs,
                                 val_ptrs);
        }
      });
    }
    for (auto& th : ts) th.join();
  }
  return 0;
}

}  // extern "C"
