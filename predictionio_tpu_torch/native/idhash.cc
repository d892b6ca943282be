// Batch string hashing for the big-ID path (HashedIdMap).
//
// BiMap-style exact indexing holds every unique id in a host dict; at
// billions of ids that is a memory wall (SURVEY §7 flags it). The hashed
// path needs only a hash per id — this kernel hashes a whole chunk of ids
// (concatenated bytes + end offsets, the same pool layout ratings.cc uses)
// in one native call, threaded.
//
// Hash: fnv1a64 seeded with a caller salt (salt=0 reproduces the event
// log's evlog_fnv1a64 exactly).

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

inline uint64_t fnv1a64(const uint8_t* data, int64_t len, uint64_t salt) {
  uint64_t h = 14695981039346656037ull ^ salt;
  for (int64_t i = 0; i < len; i++) {
    h ^= (uint64_t)data[i];
    h *= 1099511628211ull;
  }
  return h ? h : 1;
}

}  // namespace

extern "C" {

// buf: concatenated UTF-8 ids; ends[i] = exclusive end offset of id i
// (id i spans [ends[i-1], ends[i])). Writes n hashes to out.
void pio_fnv1a64_batch(const uint8_t* buf, const int64_t* ends, int64_t n,
                       uint64_t salt, uint64_t* out) {
  unsigned hw = std::thread::hardware_concurrency();
  int nthreads = hw == 0 ? 4 : (int)std::min(hw, 16u);
  if (n < 4096) nthreads = 1;
  const int64_t chunk = (n + nthreads - 1) / nthreads;
  std::vector<std::thread> ts;
  for (int t = 0; t < nthreads; ++t) {
    ts.emplace_back([&, t]() {
      const int64_t lo = t * chunk;
      const int64_t hi = std::min<int64_t>(n, lo + chunk);
      for (int64_t i = lo; i < hi; ++i) {
        int64_t start = i == 0 ? 0 : ends[i - 1];
        out[i] = fnv1a64(buf + start, ends[i] - start, salt);
      }
    });
  }
  for (auto& th : ts) th.join();
}

}  // extern "C"
